"""Node pops a ray cast: the frame kernel's counter rows (make_stats_fn)
of one sample of the window's last view, all walk phases, over the rays
that sample cast; a program counter, read after the window."""


def read(run):
    if not run.rays_cast:
        return None
    return run.node_pops / run.rays_cast
