"""On the card: each cell at its own size, three seeds, short windows; the
program's check comes out correct and the control's (the reference in
TF32 in the program's place) does not.  Skips without a card:

    python -m pytest portbench/test_portbench_control.py -m cuda -q
"""

import pytest
import torch

from portbench import harness, spec

SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read at the cell's size on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]])
def test_the_control_fails_where_the_program_passes(card, name):
    cell = spec.find_cell(name)
    session = harness.Session(cell.config, card)
    for seed in SEEDS:
        run, gestures, kept = harness.run_window(session, name, cell.traffic, seed, 1.0, False)
        harness.check(session, run, gestures, kept, seed, control=True)
        assert harness.verdict(run.check, cell.limits), (seed, run.check)
        assert not harness.verdict(run.control, cell.limits), (seed, run.control)
