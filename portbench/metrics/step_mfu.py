"""The whole request's share of the card's peak, in %: the least time the
traced window's samples could take (costs.py, on the reference walk's
counted work) over the traced window's seconds."""


def read(run):
    t, bound = run.trace, run.bound_s_per_sample()
    if t is None or not t.requests or t.window_s <= 0 or bound is None:
        return None
    return 100.0 * bound * t.requests * run.samples / t.window_s
