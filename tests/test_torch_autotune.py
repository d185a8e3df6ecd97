"""The port's autotune (shader_ray_tpu_torch/utils/autotune.py) against the
reference's (shader_ray_tpu/utils/autotune.py), both on the CPU.

With the same fake timer patched into both modules' ``_time_candidate``
and a space over knobs both ``Config``s share with equal defaults
(``packet_max_steps``, ``env_aniso``, ``min_contrib``), the two searches
pick the same winner, measure the same tags and persist the same
``best``, ``results_ms`` and ``samples``: a stage interaction that needs a
second pass, a failing candidate, an exact-space hit, the prior-space
fallback and seed, a retired knob value dropped, the SRT_TUNE_REPO write
switch, and a search where every candidate fails.  The TPU records
committed in ``tunes/`` never apply to the port.  A real tune through the
REPL on the box fixture at 64x64 measures the 5 distinct launch shapes of
``DEFAULT_SPACE``, persists and applies its winner, and hits its cache
the second time."""

import copy
import io
import json
import types

import pytest
import torch

import shader_ray_tpu.utils.autotune as ref_at
import shader_ray_tpu_torch.utils.autotune as port_at
from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.ops.render import RenderStatics as RefStatics
from shader_ray_tpu_torch.app.driver import App
from shader_ray_tpu_torch.app.main import repl
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.models import fixtures
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.ops.render import RenderStatics
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIDES = {"ref": (ref_at, RefConfig, RefStatics), "port": (port_at, Config, RenderStatics)}
STAGES = [
    [{"packet_max_steps": 0}, {"packet_max_steps": 64}],
    [{"env_aniso": 4}, {"env_aniso": 1}],
]


def _renderer(side: str):
    """What the search reads of a renderer: its config (and the port's
    device); ``_time_candidate`` is faked."""
    _, config, _ = SIDES[side]
    return types.SimpleNamespace(cfg=config(use_native="never"), device=torch.device("cpu"))


def _record(path) -> str:
    """A persisted record's best, results_ms and samples, as JSON."""
    rec = json.loads(path.read_text())
    return json.dumps([rec["best"], rec.get("results_ms"), rec["samples"]], sort_keys=True)


def _run(side, tmp_path, monkeypatch, timer, *, key="k", space=STAGES, samples=2):
    """``autotune`` of ``side`` under its own cache dir and repo store in
    ``tmp_path``, timed by ``timer(cfg)``: (best, results, the persisted
    records' best/results_ms/samples, the renderer's knobs after)."""
    at, _, statics_type = SIDES[side]
    cache, repo = tmp_path / side / "cache", tmp_path / side / "tunes"
    repo.mkdir(parents=True, exist_ok=True)
    monkeypatch.setenv("SRT_CACHE_DIR", str(cache))
    monkeypatch.setattr(at, "_repo_tune_dir", lambda: str(repo))
    calls = []

    def fake_time(renderer, cfg, statics, params, samples, frames):
        calls.append(json.dumps({k: getattr(cfg, k) for k in ("packet_max_steps", "env_aniso",
                                                                "min_contrib")}))
        return timer(cfg)

    monkeypatch.setattr(at, "_time_candidate", fake_time)
    r = _renderer(side)
    best, results = at.autotune(r, statics_type(width=16, height=8), None, samples=samples,
                                frames=1, key=key, space=space, verbose=False)
    records = {d.name: sorted(_record(f) for f in d.glob(f"tune-{key}-*.json"))
               for d in (cache, repo) if d.exists()}
    knobs = {k: getattr(r.cfg, k) for k in ("packet_max_steps", "env_aniso", "min_contrib")}
    return best, results, records, knobs, calls


def _both(tmp_path, monkeypatch, timer, **kw):
    ref = _run("ref", tmp_path, monkeypatch, timer, **kw)
    port = _run("port", tmp_path, monkeypatch, timer, **kw)
    assert ref == port
    return port


def test_stage_interaction_needs_a_second_pass(tmp_path, monkeypatch):
    """The reference's test_iterated_descent_escapes_stage_interaction:
    pass 1 lands (0, 1); the re-sweep finds (64, 1), the joint optimum."""
    times = {(0, 4): 0.010, (64, 4): 0.011, (0, 1): 0.009, (64, 1): 0.007}
    best, results, records, knobs, calls = _both(
        tmp_path, monkeypatch, lambda c: times[(c.packet_max_steps, c.env_aniso)])
    assert best == {"packet_max_steps": 64, "env_aniso": 1} == {k: knobs[k] for k in best}
    assert len(results) == 4 and len(calls) == 4 and len(set(calls)) == 4
    assert json.loads(records["cache"][0])[0] == best and not records["tunes"]


def test_a_failing_candidate_is_dropped_and_not_retried(tmp_path, monkeypatch):
    def timer(c):
        if c.env_aniso == 1:
            raise RuntimeError("refused launch")
        return 0.01 - 1e-3 * (c.packet_max_steps == 64)

    best, results, records, _, calls = _both(tmp_path, monkeypatch, timer)
    assert best == {"packet_max_steps": 64, "env_aniso": 4}
    assert len(results) == 2 and len(calls) == 3  # the failed tag is tried once


def test_an_exact_space_hit_measures_nothing(tmp_path, monkeypatch):
    _both(tmp_path, monkeypatch, lambda c: 0.01 - 1e-3 * (c.env_aniso == 1))
    best, results, _, knobs, calls = _both(tmp_path, monkeypatch, lambda c: 1 / 0)
    assert best == {"packet_max_steps": 0, "env_aniso": 1} and results == {} and calls == []
    assert knobs["env_aniso"] == 1  # applied


def _old_record(side, tmp_path, best, old_space, samples=2, ts=100.0):
    at, _, statics_type = SIDES[side]
    statics = statics_type(width=16, height=8)
    cache = tmp_path / side / "cache"
    cache.mkdir(parents=True, exist_ok=True)
    h = at._space_key(statics, samples, old_space)
    (cache / f"tune-k-{h}.json").write_text(json.dumps({
        "best": best, "samples": samples, "ts": ts, "statics_tag": at._statics_tag(statics)}))
    return statics


@pytest.mark.parametrize("side", ["ref", "port"])
def test_prior_space_fallback_and_seed(tmp_path, monkeypatch, side):
    """A record of an edited-away space applies through the fallback but
    is no cache hit for a search, which starts from it instead."""
    old_space = [[{"min_contrib": 0.0}, {"min_contrib": 0.004}]]
    statics = _old_record(side, tmp_path, {"min_contrib": 0.004}, old_space)
    at = SIDES[side][0]
    monkeypatch.setenv("SRT_CACHE_DIR", str(tmp_path / side / "cache"))
    monkeypatch.setattr(at, "_repo_tune_dir", lambda: None)
    assert at.load_tuned("k", statics, 2, STAGES) == {"min_contrib": 0.004}
    assert at.load_tuned("k", statics, 2, STAGES, fallback=False) is None
    assert at.load_tuned("k", statics._replace(which=1), 2, STAGES) is None


def test_a_search_seeds_from_the_prior_winner(tmp_path, monkeypatch):
    for side in SIDES:
        _old_record(side, tmp_path, {"min_contrib": 0.004}, [[{"min_contrib": 0.0}]])
    best, results, records, knobs, calls = _both(
        tmp_path, monkeypatch, lambda c: 0.01 - 1e-3 * (c.packet_max_steps == 64))
    assert best == {"min_contrib": 0.004, "packet_max_steps": 64, "env_aniso": 4}
    assert calls and all(json.loads(c)["min_contrib"] == 0.004 for c in calls)
    assert knobs["min_contrib"] == 0.004


def test_a_retired_knob_value_is_dropped(tmp_path, monkeypatch):
    got = {}
    for side in SIDES:
        statics = _old_record(side, tmp_path, {"packet_kernel": "quad", "min_contrib": 0.004, "no_such": 1},
                              [[{"env_aniso": 4}]])
        at = SIDES[side][0]
        monkeypatch.setenv("SRT_CACHE_DIR", str(tmp_path / side / "cache"))
        monkeypatch.setattr(at, "_repo_tune_dir", lambda: None)
        got[side] = at.load_tuned("k", statics, 2, STAGES)
    assert got["ref"] == got["port"] == {"min_contrib": 0.004}


def test_the_repo_store_is_written_only_under_srt_tune_repo(tmp_path, monkeypatch):
    monkeypatch.delenv("SRT_TUNE_REPO", raising=False)
    _, _, records, _, _ = _both(tmp_path, monkeypatch, lambda c: 0.01, key="w")
    assert records["cache"] and not records["tunes"]
    monkeypatch.setenv("SRT_TUNE_REPO", "1")
    _, _, records, _, _ = _both(tmp_path, monkeypatch, lambda c: 0.01, key="w2")
    assert records["cache"] == records["tunes"] and records["tunes"]


def test_an_all_failed_search_persists_nothing(tmp_path, monkeypatch, capsys):
    best, results, records, _, calls = _both(tmp_path, monkeypatch, lambda c: 1 / 0)
    assert best == {} and results == {} and len(calls) == 3
    assert records == {"cache": [], "tunes": []} or not any(records.values())
    assert capsys.readouterr().err.count("no candidate measured; nothing persisted") == 2


def test_the_tpu_records_never_apply_to_the_port(monkeypatch, tmp_path):
    """``tunes/`` holds the reference's TPU tunes of the bench scene: the
    port's device tag and Config keep them out."""
    monkeypatch.setenv("SRT_CACHE_DIR", str(tmp_path))
    assert port_at._repo_tune_dir() is not None
    statics = RenderStatics.from_config(Config(), width=1024, height=768)
    for samples in (32, 1024):
        assert port_at.load_tuned("bench-bunny-class-69k-l10-d30", statics, samples) is None
    assert port_at._validate_knobs({"jitter_pack": 1024, "prog_tile": 8}) is None


@pytest.fixture(scope="module")
def box_app():
    cfg = Config(use_native="never")
    world = make_world(TriangleSet.from_arrays(fixtures.box()), cfg)
    renderer = Renderer(get_shader_data(world, cfg), fixtures.procedural_sky(64), cfg, device="cpu")
    app = App(world, renderer, cfg, width=64, height=64)
    app.scene_key = "box-test"
    return app


def test_repl_tune_measures_persists_and_applies(box_app, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SRT_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(port_at, "_repo_tune_dir", lambda: None)
    monkeypatch.chdir(tmp_path)
    app = box_app
    repl(app, "frame.ppm", iter(["tune 2", "tune 2", "set frame_tile 32", "set frame_tile 12",
                                 "set frame_warp bricks", "q"]))
    err = capsys.readouterr().err
    # pass 0 measures the 4 widths and "bricks" at the widest winner ("rows"
    # is the default, a measured tag); should "bricks" win, pass 1 measures
    # the other 3 widths with it
    measured = [s for s in err.splitlines() if s.startswith("autotune[")]
    first = {s.split(": ", 1)[1].rsplit(" -> ", 1)[0] for s in measured if s.startswith("autotune[0]")}
    assert len(first) == 5 and len(measured) in (5, 8)
    records = list(tmp_path.glob("tune-box-test-*.json"))
    assert len(records) == 1
    saved = json.loads(records[0].read_text())
    assert len(saved["results_ms"]) == len(measured) and saved["samples"] == 2
    best = saved["best"]
    assert set(best) == {"frame_tile", "frame_warp"}
    assert err.count("applied: ") == 2 and f"autotune cache hit: {best}" in err
    assert "frame_tile = 32" in err and "frame_tile=12: use one of (8, 16, 32, 64)" in err
    assert (app.cfg.frame_tile, app.cfg.frame_warp) == (32, "bricks")
    assert app.renderer.cfg is app.cfg


def test_tune_needs_the_fused_route(box_app):
    out = io.StringIO()
    renderer = copy.copy(box_app.renderer)
    renderer.cfg = Config(packet_fused=False)
    app = App(box_app.world, renderer, renderer.cfg, width=64, height=64)
    assert app.tune(2, file=out) is None
    assert "autotune needs the fused frame kernel" in out.getvalue()
