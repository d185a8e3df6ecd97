"""A cell added as new files alone, in a copied checkout: a scene
generator file and a configuration whose view turns the light and the
object by drags, run whole on the CPU through run_window and check at
the tiny size; and a traced run's program spans and walk counters."""

import collections
import copy
import dataclasses
import json

import pytest

from portbench import harness, spec
from portbench.conftest import copy_checkout, tiny_cell
from portbench.test_portbench_scene import RIDGES

DRAGS = [{"target": "light", "x": 0.22, "y": -0.12}, {"target": "object", "x": 0.04, "y": 0.15}]


def _ridges_cell(tmp_path) -> tuple[spec.Cell, object]:
    root = copy_checkout(tmp_path)
    pkg = root / "portbench"
    (pkg / "scenes").mkdir()
    (pkg / "scenes" / "ridges.py").write_text(RIDGES)
    config = spec.load_json(pkg / "configs" / "bunny69k.json")
    config.update(name="ridges2k")
    config["scene"] = {"generator": "ridges", "target_tris": 2000, "sky_width": 256, "lift": 0.2}
    config["view"]["drags"] = DRAGS
    (pkg / "configs" / "ridges2k.json").write_text(json.dumps(config))
    (pkg / "limits" / "ridges2k.interactive.json").write_text(
        (pkg / "limits" / "bunny69k.interactive.json").read_text())
    bench = spec.load_json(root / "BENCHMARK.json")
    bench["configs"].append({"name": "ridges2k", "source": "test", "file": "portbench/configs/ridges2k.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "ridges2k.interactive", "config": "ridges2k",
                               "traffic": "interactive", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_cell("ridges2k.interactive", None, root), root


class Counting:
    """The Renderer, its frame functions counted as one frame-kernel
    launch through a plan each, as the card's route counts them."""

    def __init__(self, renderer, build):
        self._renderer, self._build = renderer, build

    def __getattr__(self, name):
        return getattr(self._renderer, name)

    def make_fn(self, statics):
        fn = self._renderer.make_fn(statics)

        def call(params):
            self._build.LAUNCHES["frame_kernel"] += 1
            self._build.PLANS["frame_kernel"] += 1
            return fn(params)

        return call


def test_a_new_scene_with_drags_runs_whole_and_correct(tmp_path, monkeypatch):
    from shader_ray_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    monkeypatch.setattr(_build, "PLANS", collections.Counter())
    cell, root = _ridges_cell(tmp_path)
    assert cell.config["view"]["drags"] == DRAGS and cell.limits
    session = harness.Session(cell.config, "cpu", wrap=lambda r: Counting(r, _build), root=root)
    assert session.tri.shape == (2 * 31 * 31, 3, 3)
    seed = 2**31 + 21
    run, gestures, kept = harness.run_window(session, cell.name, cell.traffic, seed, 1.0, False)
    assert run.requests >= 2 and run.trace is None and run.counters == {}
    assert run.launches == {"frame_kernel": run.requests, "plans.frame_kernel": run.requests}
    harness.check(session, run, gestures, kept, seed)
    assert harness.verdict(run.check, cell.limits), run.check
    # the reference without either drag sees another picture than the App's
    for left_out in DRAGS:
        config = copy.deepcopy(run.config)
        config["view"]["drags"] = [d for d in DRAGS if d is not left_out]
        blind = dataclasses.replace(run, config=config)
        harness.check(session, blind, gestures, kept, seed)
        assert not harness.verdict(blind.check, cell.limits), (left_out, blind.check)


def test_a_traced_run_holds_the_programs_spans_and_counters(tiny_session):
    from shader_ray_tpu_torch.ops.frame_kernel import stats_phases

    cell = tiny_cell("bunny69k.interactive")
    mix = dict(cell.traffic, warmup=1, trace_seconds=0.5)
    run, _, _ = harness.run_window(tiny_session, cell.name, mix, 2**31 + 22, 1.0, True)
    t = run.trace
    assert t is not None and t.requests >= 1
    for name in ("app.drag", "app.frame_params", "engine.frame", "frame_kernel.call", "app.copy"):
        assert t.spans_n[name] == t.requests and 0 < t.spans_s[name] <= t.window_s, name
    assert not any(name.startswith("pb.") for name in t.spans_s)
    phases = stats_phases(3, True, True)
    assert set(run.counters) == {"rays_cast"} | {f"{p}.{k}" for p in phases for k in harness.COUNTER_COLUMNS}
    assert run.node_pops == sum(run.counters[f"{p}.node_pops"] for p in phases) > 0
    assert run.rays_cast == run.counters["rays_cast"] >= 48 * 32
    assert run.counters["shadow0.node_pops"] > 0
