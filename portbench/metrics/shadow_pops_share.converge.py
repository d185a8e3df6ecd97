"""Share of the node pops in the any-hit shadow walks, in %: the frame
kernel's counter rows (make_stats_fn) of one sample of the window's last
view, the ``shadow*`` phases' node pops over all phases'; a program
counter, read after the window."""


def read(run):
    if not run.node_pops:
        return None
    shadow = sum(v for k, v in run.counters.items()
                 if k.startswith("shadow") and k.endswith(".node_pops"))
    return 100.0 * shadow / run.node_pops
