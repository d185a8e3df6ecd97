"""The port's bench (shader_ray_tpu_torch/bench.py) against bench.py, on
the CPU: the golden gate decides as ``bench._golden_gate`` does on the
same arrays; ``build_scene_data`` gives bench.py's key and tables; ``main``
under BENCH_DEVICE=cpu at a tiny size prints a last line with every
field (and no ``vs_baseline``), its value consistent with its frame time
and its cast rays the Renderer's count; a sub-metric or the cast count
that raises leaves an ``error`` entry and exit 4; BENCH_TUNE=1 searches
the launch shape of each scene (a fake timer), ``auto`` applies the
persisted tunes without searching and ``0`` keeps the defaults, each
scene timed under its own; without a card the bench exits non-zero; the functions the port keeps
take bench.py's parameters (an AST walk)."""

import ast
import contextlib
import io
import json
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.config import use_config
from shader_ray_tpu_torch import bench as port_bench
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.ops.render import RenderStatics
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench as ref_bench  # noqa: E402

GATE_ENV = ("BENCH_GOLDEN", "BENCH_TRIS", "BENCH_WHICH", "BENCH_SHADOWS", "BENCH_BOUNCES")
TINY = {"WIDTH": 32, "HEIGHT": 24, "BATCH": 2, "FRAMES": 1, "LARGE_TRIS": 3000}
TINY_ENV = {"BENCH_DEVICE": "cpu", "BENCH_TRIS": "2000", "SRT_NATIVE": "never"}
FIELDS = ("metric", "value", "unit", "rays_potential", "frame_ms", "frame_ms_single_dispatch",
          "frames_per_dispatch", "rays_cast", "mrays_per_s_cast", "occluded", "which1",
          "large_340k", "device")


def _upsample(img4):
    """Invert the gate's 4x box downsample exactly (nearest blow-up)."""
    return np.repeat(np.repeat(img4, 4, axis=0), 4, axis=1)


def _gate_outcome(gate, img, capsys):
    """(exit code or None, the gate's stderr line, the error line's
    payload or None) of one gate call."""
    code = None
    try:
        gate(img)
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    line = [s for s in out.err.splitlines() if s.startswith("golden gate:")][-1]
    payload = json.loads(out.out.strip().splitlines()[-1]) if out.out.strip() else None
    return code, line.split(" (")[0], payload


@pytest.mark.parametrize("case", ["golden", "corrupted", "non-canonical", "opt-out"])
def test_gate_decides_as_bench_py(case, monkeypatch, capsys):
    for var in GATE_ENV:
        monkeypatch.delenv(var, raising=False)
    img = _upsample(np.load(port_bench.GOLDEN))
    if case == "corrupted":
        img[100:200, 300:500] += 0.2  # a visibly wrong region
    elif case == "non-canonical":
        img = np.zeros_like(img)
        monkeypatch.setenv("BENCH_WHICH", "1")
    elif case == "opt-out":
        img = np.zeros_like(img)
        monkeypatch.setenv("BENCH_GOLDEN", "0")
    ref = _gate_outcome(ref_bench._golden_gate, img, capsys)
    got = _gate_outcome(port_bench._golden_gate, img, capsys)
    want_line = {"golden": "golden gate: ok", "corrupted": "golden gate: FAILED"}.get(
        case, "golden gate: skipped")
    assert got[:2] == ref[:2] == ((3 if case == "corrupted" else None), want_line)
    if case == "corrupted":
        for payload in (ref[2], got[2]):
            assert payload["value"] == 0.0 and "GOLDEN GATE FAILED" in payload["error"]
        assert "vs_baseline" not in got[2]
    else:
        assert got[2] is None and ref[2] is None


def test_build_scene_data_matches_bench_py(tmp_path, monkeypatch):
    monkeypatch.setenv("SRT_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("SRT_NATIVE", "never")
    with use_config(RefConfig(use_native="never")):
        ref_data, ref_sky, ref_key = ref_bench.build_scene_data(2000)
    data, sky, key = port_bench.build_scene_data(2000)
    assert key == ref_key == "bench-bunny-class-2k-l10-d30"
    assert (data.triangle_count, data.group_count, data.tree_root) == \
        (ref_data.triangle_count, ref_data.group_count, ref_data.tree_root)
    for name in ("node_boxes", "node_objects", "node_children", "tri_positions", "tri_normals",
                 "tri_colors", "hitmiss"):
        np.testing.assert_array_equal(getattr(data, name), getattr(ref_data, name), err_msg=name)
    np.testing.assert_array_equal(sky, ref_sky)
    assert (tmp_path / f"torch-scene-{key}-v1.npz").exists()
    # a second call is a cache hit with the same tables
    again, _, _ = port_bench.build_scene_data(2000)
    np.testing.assert_array_equal(again.node_boxes, data.node_boxes)


@contextlib.contextmanager
def _tiny(env: dict, **patches):
    """The bench at TINY size on the CPU under ``env``, with ``patches``
    set on the module."""
    with pytest.MonkeyPatch.context() as mp:
        for var in (*GATE_ENV, "BENCH_OCCLUDED", "BENCH_EXTRAS", "BENCH_TUNE", "BENCH_GOLDEN"):
            mp.delenv(var, raising=False)
        for var, value in {**TINY_ENV, **env}.items():
            mp.setenv(var, value)
        for name, value in {**TINY, **patches}.items():
            mp.setattr(port_bench, name, value)
        yield


def _run_main(env: dict, **patches):
    """(exit code, stdout's last line as JSON, stderr) of ``main()``."""
    out, err, code = io.StringIO(), io.StringIO(), 0
    with _tiny(env, **patches), contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            port_bench.main()
        except SystemExit as e:
            code = e.code
    return code, json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("bench_cache"))
    return cache, _run_main({"SRT_CACHE_DIR": cache, "BENCH_TUNE": "auto"})


def _keys(d) -> set:
    return set(d) | {k for v in d.values() if isinstance(v, dict) for k in _keys(v)}


def test_main_prints_every_field(tiny_run):
    _, (code, line, err) = tiny_run
    assert code == 0, err
    assert set(FIELDS) <= set(line) and "vs_baseline" not in _keys(line) and "error" not in _keys(line)
    assert (line["metric"], line["unit"]) == ("mrays_per_s", "Mrays/s")
    assert line["rays_potential"] == 32 * 24 * 6 and line["frames_per_dispatch"] == 2
    assert line["device"] == {"name": "cpu", "count": 1, "power_limit_w": None}
    assert line["occluded"]["metric"] == "mrays_per_s_occluded"
    for key in ("occluded", "which1", "large_340k"):
        sub = line[key]
        assert {"value", "unit", "frame_ms", "frames_per_dispatch"} <= set(sub), key
        assert sub["frame_ms"] > 0 and sub["value"] > 0
    assert "golden gate: skipped (non-canonical" in err and "compile+first frame" in err
    assert "large scene: 2916 tris" in err


def test_main_value_agrees_with_frame_ms(tiny_run):
    """Mrays/s = rays / frame time, within the rounding of both (value to
    2 decimals, milliseconds to 3)."""
    _, (_, line, _) = tiny_run
    for sub in (line, line["occluded"], line["which1"], line["large_340k"]):
        ms = sub["frame_ms"]
        hi, lo = line["rays_potential"] / ((ms - 5e-4) * 1e3), line["rays_potential"] / ((ms + 5e-4) * 1e3)
        assert lo - 0.005 <= sub["value"] <= hi + 0.005, sub
    ms = line["frame_ms"]
    cast_hi, cast_lo = line["rays_cast"] / ((ms - 5e-4) * 1e3), line["rays_cast"] / ((ms + 5e-4) * 1e3)
    assert cast_lo - 0.005 <= line["mrays_per_s_cast"] <= cast_hi + 0.005


def test_main_rays_cast_is_the_renderers_count(tiny_run, monkeypatch):
    cache, (_, line, _) = tiny_run
    monkeypatch.setenv("SRT_CACHE_DIR", cache)
    with _tiny({}):
        data, sky, _ = port_bench.build_scene_data()
        statics = RenderStatics.from_config(Config(), width=32, height=24)
        params = port_bench._frame_params(2.6, np.deg2rad(40.0), (0.8, 0.2, 0.2), 0.05)
        cast = Renderer(data, sky, Config(use_native="never"), device="cpu").make_count_fn(statics)(params)
    assert line["rays_cast"] == cast > 32 * 24


@pytest.mark.parametrize("fails", ["occluded", "rays_cast"])
def test_a_failed_measurement_exits_4(fails, tiny_run, monkeypatch):
    cache, _ = tiny_run

    def boom(*args, **kwargs):
        raise RuntimeError("injected failure")

    if fails == "occluded":
        code, line, err = _run_main({"SRT_CACHE_DIR": cache, "BENCH_EXTRAS": "0", "BENCH_TUNE": "0"},
                                    bench_occluded=boom)
    else:
        monkeypatch.setattr(Renderer, "make_count_fn", boom)
        code, line, err = _run_main({"SRT_CACHE_DIR": cache, "BENCH_EXTRAS": "0",
                                     "BENCH_OCCLUDED": "0"})
    assert code == 4
    assert line[fails] == {"error": "RuntimeError: injected failure"}
    assert line["value"] > 0 and line["frame_ms"] > 0  # the headline still stands
    assert f"{fails} failed: injected failure" in err


def _fake_time(renderer, cfg, statics, params, samples, frames):
    """A candidate timer that favours 32-pixel tiles in rows (64-pixel
    tiles at which=1)."""
    want = 64 if statics.which == 1 else 32
    return 1e-3 * (1 + (cfg.frame_tile != want) + (cfg.frame_warp != "rows"))


def _bench_tune(cache: str, mode: str | None):
    """``_run_main`` in ``cache`` under BENCH_TUNE=``mode`` (None: unset),
    with no repo tune store and the fake timer; its result and the
    (which, tile, warp) of each scene's timed batches."""
    import shader_ray_tpu_torch.utils.autotune as at

    timed = []
    sample_time = port_bench._sample_time

    def recording(renderer, statics, params, batch, frames):
        timed.append((statics.which, renderer.cfg.frame_tile, renderer.cfg.frame_warp))
        return sample_time(renderer, statics, params, batch, frames)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(at, "_repo_tune_dir", lambda: None)
        mp.setattr(at, "_time_candidate", _fake_time)
        env = {"SRT_CACHE_DIR": cache, **({} if mode is None else {"BENCH_TUNE": mode})}
        return (*_run_main(env, _sample_time=recording), timed)


@pytest.fixture(scope="module")
def tuned_run(tiny_run, tmp_path_factory):
    """BENCH_TUNE=1 in a cache dir with the tiny run's scenes and no tune."""
    import shutil

    cache = tmp_path_factory.mktemp("tuned_cache")
    for scene in pathlib.Path(tiny_run[0]).glob("torch-scene-*.npz"):
        shutil.copy(scene, cache)
    return cache, _bench_tune(str(cache), "1")


def _copy_of(tuned_run, tmp_path) -> pathlib.Path:
    import shutil

    cache = tmp_path / "cache"
    shutil.copytree(tuned_run[0], cache)
    return cache


def test_bench_tune_1_searches_each_scene_and_persists(tuned_run):
    cache, (code, line, err, timed) = tuned_run
    assert code == 0, err
    assert "error" not in _keys(line)
    # the headline, occluded, which1 and large_340k: one search each, 5 shapes
    assert err.count("autotune best: ") == 4
    assert err.count("autotune best: {'frame_tile': 32, 'frame_warp': 'rows'}") == 3
    assert err.count("autotune best: {'frame_tile': 64, 'frame_warp': 'rows'}") == 1
    assert err.count("autotune[0]: ") == 4 * 5 and "autotune[1]: " not in err
    records = sorted(cache.glob("tune-*.json"))
    assert len(records) == 4
    assert all(json.loads(r.read_text())["samples"] == TINY["BATCH"] for r in records)
    # each scene timed under its own winner: the headline batches, occluded,
    # then which1 at its own tune (not the headline's), large_340k
    assert timed == [(0, 32, "rows"), (0, 32, "rows"), (1, 64, "rows"), (0, 32, "rows")]


def test_bench_tune_auto_applies_without_searching(tuned_run, tmp_path):
    cache = _copy_of(tuned_run, tmp_path)
    which1 = [r for r in cache.glob("tune-bench-bunny-class-2k-*.json")
              if json.loads(r.read_text())["best"]["frame_tile"] == 64]
    assert len(which1) == 1
    which1[0].unlink()  # which1 then has no tune and runs from the pre-tune config
    code, line, err, timed = _bench_tune(str(cache), None)  # unset: auto
    assert code == 0, err
    assert "autotune" not in err
    assert err.count("applying cached tune: {'frame_tile': 32, 'frame_warp': 'rows'}") == 3
    assert timed == [(0, 32, "rows"), (0, 32, "rows"), (1, 16, "rows"), (0, 32, "rows")]


def test_bench_tune_0_keeps_the_defaults(tuned_run, tmp_path):
    code, _, err, timed = _bench_tune(str(_copy_of(tuned_run, tmp_path)), "0")
    assert code == 0, err
    assert "autotune" not in err and "applying cached tune" not in err
    assert timed == [(0, 16, "rows")] * 2 + [(1, 16, "rows"), (0, 16, "rows")]


def test_no_card_exits_nonzero(monkeypatch, capsys):
    """``python -m shader_ray_tpu_torch.bench`` (run as ``__main__``) on a
    host without a card and without BENCH_DEVICE."""
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.delenv("BENCH_TUNE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delitem(sys.modules, "shader_ray_tpu_torch.bench")  # run afresh, as -m does
    with pytest.raises(SystemExit) as e:
        runpy.run_module("shader_ray_tpu_torch.bench", run_name="__main__")
    assert e.value.code == 2
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["value"] == 0.0 and "BENCH_DEVICE=cpu" in payload["error"]


def _params(path: pathlib.Path) -> dict:
    """Module-level function name -> (positional, keyword-only) parameters."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            a = node.args
            out[node.name] = ([x.arg for x in a.posonlyargs + a.args], [x.arg for x in a.kwonlyargs])
    return out


@pytest.mark.parametrize("name", ["build_scene_data", "main", "bench_occluded", "_golden_gate",
                                  "_emit_golden_fail", "_time_progressive"])
def test_kept_functions_take_bench_py_parameters(name):
    (ref_pos, ref_kw), (pos, kw) = (_params(ROOT / "bench.py")[name],
                                    _params(ROOT / "shader_ray_tpu_torch" / "bench.py")[name])
    assert pos == ref_pos and kw[:len(ref_kw)] == ref_kw
