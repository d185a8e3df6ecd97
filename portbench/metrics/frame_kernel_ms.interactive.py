"""Device milliseconds a frame of the frame kernel (csrc/frame_kernel.cu)
over the traced window's requests; profiler."""

from portbench.trace import FRAME_KERNEL, device_seconds


def read(run):
    t = run.trace
    if t is None or not t.requests:
        return None
    s = device_seconds(t, FRAME_KERNEL)
    return 1e3 * s / t.requests if s > 0 else None
