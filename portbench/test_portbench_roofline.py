"""The roofline's work count reads the same work whatever implements it:
the reference walk's counts do not move when the port builds another tree
(object splits against splits="sbvh"), while the port's own tables do."""

import copy

from portbench import harness
from portbench.conftest import tiny_cell


def test_counted_work_ignores_the_ports_tree():
    cell = tiny_cell("bunny69k.interactive")
    seed = 2**32 + 5
    counts, tables = [], []
    for splits in ("object", "sbvh"):
        config = copy.deepcopy(cell.config)
        config["program"]["splits"] = splits
        session = harness.Session(config, "cpu")
        run, gestures, kept = harness.run_window(session, cell.name, cell.traffic, seed, 0.3, False)
        kept.items = kept.items[:1]  # the same frame of both runs: the first of the window
        harness.check(session, run, gestures, kept, seed)
        assert kept.items[0][0] == 0 and harness.verdict(run.check, cell.limits)
        counts.append((run.work, run.checked_rays, run.bound_s_per_sample()))
        tables.append(session.renderer.packed.nodes)
    assert counts[0] == counts[1] and counts[0][0].slabs > 0
    assert tables[0].shape != tables[1].shape or not (tables[0] == tables[1]).all()
