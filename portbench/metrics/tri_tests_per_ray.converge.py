"""Triangle tests a ray cast: the frame kernel's counter rows
(make_stats_fn) of one sample of the window's last view, every phase's
``tri_tests`` over the rays that sample cast; a program counter, read
after the window."""


def read(run):
    if not run.rays_cast:
        return None
    return sum(v for k, v in run.counters.items() if k.endswith(".tri_tests")) / run.rays_cast
