"""Full-image samples a second: the samples of every progressive request
completed in the window over the window's seconds; host clock."""


def read(run):
    if run.traffic["request"] != "progressive" or run.window_s <= 0:
        return None
    return run.requests * run.samples / run.window_s
