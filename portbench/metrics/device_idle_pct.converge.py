"""Share of the traced window with no kernel or copy on the card, in %;
profiler."""

from portbench.trace import idle_pct


def read(run):
    return idle_pct(run.trace)
