"""The frame kernel's share of its roofline, in %: the least time a
full-image sample could take (costs.py, on the reference walk's counted
work) over the kernel's device time a sample in the traced window."""

from portbench.trace import FRAME_KERNEL, device_seconds


def read(run):
    t, bound = run.trace, run.bound_s_per_sample()
    if t is None or not t.requests or bound is None:
        return None
    s = device_seconds(t, FRAME_KERNEL)
    if s <= 0:
        return None
    return 100.0 * bound / (s / (t.requests * run.samples))
