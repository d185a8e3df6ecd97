"""A run with the timed path broken underneath comes out not correct, and
one unbroken comes out correct: the harness's run and check, past its
look for a card, on the port's plain versions at a tiny size.

The faults a cell can have: a frame function that returns its previous
output (a step that leaves its state unchanged), a progressive batch of
half its samples with the mean over those (half of the batch left out;
converge cells only: a single frame has no batch), and an answer altered
where it is produced (each frame 2% brighter).  No cell has an exchange
between cards to leave out."""

import pytest

from portbench import harness
from portbench.conftest import tiny_cell


class Faulty:
    """The Renderer with one fault in its frame functions."""

    def __init__(self, renderer, fault: str | None):
        self._renderer, self._fault = renderer, fault

    def __getattr__(self, name):
        return getattr(self._renderer, name)

    def make_fn(self, statics):
        return self._broken(self._renderer.make_fn(statics))

    def make_progressive_fn(self, statics, samples, reduce_sum=False):
        if self._fault == "half":
            samples //= 2
        return self._broken(self._renderer.make_progressive_fn(statics, samples, reduce_sum))

    def _broken(self, fn):
        last = []

        def call(params):
            if self._fault == "stale" and last:
                return last[0]
            out = fn(params)
            last[:] = [out]
            return out * 1.02 if self._fault == "altered" else out

        return call


CASES = [("bunny69k.interactive", None), ("bunny69k.interactive", "stale"),
         ("bunny69k.interactive", "altered"), ("bunny69k.converge", None),
         ("bunny69k.converge", "stale"), ("bunny69k.converge", "half"),
         ("bunny69k.converge", "altered")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_path_is_not_correct(name, fault):
    cell = tiny_cell(name)
    session = harness.Session(cell.config, "cpu", wrap=lambda r: Faulty(r, fault))
    seed = 2**31 + 11
    run, gestures, kept = harness.run_window(session, cell.name, cell.traffic, seed, 0.5, False)
    harness.check(session, run, gestures, kept, seed)
    assert run.requests >= 2
    assert harness.verdict(run.check, cell.limits) == (fault is None), run.check
