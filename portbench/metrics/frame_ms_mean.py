"""Milliseconds a frame while dragging: the window's seconds over the
frames completed in it, each from its drag to the frame on the host;
host clock."""


def read(run):
    if run.traffic["request"] != "frame" or not run.requests:
        return None
    return 1e3 * run.window_s / run.requests
