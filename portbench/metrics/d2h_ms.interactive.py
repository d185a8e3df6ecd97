"""Device milliseconds a frame of the frame's copy to the host: the
device-to-host copies of the traced window over its requests; profiler."""

from portbench.trace import COPY_TO_HOST, device_seconds


def read(run):
    t = run.trace
    if t is None or not t.requests:
        return None
    s = device_seconds(t, COPY_TO_HOST)
    return 1e3 * s / t.requests if s > 0 else None
