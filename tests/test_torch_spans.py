"""The port's spans (utils/profiling.span) on the CPU.  Off, ``span`` hands
out one shared null context and reads no clock; inside ``recording()``
each span lands in the Recorder with its frame id and enclosing span, and
``totals`` gives count, total and self seconds by name; an App's drag and
frame record each layer's span in its nesting under one frame id, and the
same names are ranges in ``device_trace``'s file; a Renderer's
construction records its pack (the collapse inside) and upload, the
scene's build and tables are spans named after the build's route, and the
kernel library's build and load are spans named after the library."""

import json
import os
import subprocess
import time

import pytest

from shader_ray_tpu_torch.app.driver import App
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.models.fixtures import procedural_sky, uv_sphere
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.ops import _build
from shader_ray_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# a single frame's jitter goes by value in the uniforms' host block: no engine.jitter
FRAME = ["app.drag", "app.frame_params", "engine.frame", "engine.uniforms",
         "frame_kernel.call", "engine.finish", "app.copy"]
INSIDE_FRAME = {"engine.uniforms", "frame_kernel.call", "engine.finish"}


@pytest.fixture(scope="module")
def scene():
    world = make_world(TriangleSet.from_arrays(*uv_sphere(lat=6, lon=8)))
    return world, get_shader_data(world), procedural_sky(64)


def _app(scene) -> App:
    world, data, sky = scene
    return App(world, Renderer(data, sky, device="cpu"), width=16, height=16)


def test_off_span_is_shared_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("an off span read the clock")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    a, b = profiling.span("app.drag"), profiling.span("engine.frame")
    assert a is b
    with profiling.span("x"):
        pass
    with profiling.recording():
        pass
    assert profiling.span("x") is a  # a closed recording leaves it off


def test_recorder_nesting_parents_self_time_and_frame_ids(monkeypatch):
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    with profiling.recording() as rec:
        profiling.set_frame(7)
        with profiling.span("outer"):            # 0 .. 50
            with profiling.span("inner"):        # 10 .. 20
                pass
            with profiling.span("inner"):        # 30 .. 40
                pass
        profiling.set_frame(8)
        with profiling.span("inner"):            # 60 .. 70
            pass
        with profiling.span("open"):
            assert [s[0] for s in rec.spans] == ["outer", "inner", "inner", "inner", "open"]
            assert rec.spans[-1][4] is None
            totals = rec.totals()
    assert [(n, f, p) for n, f, p, _, _ in rec.spans] == [
        ("outer", 7, None), ("inner", 7, 0), ("inner", 7, 0), ("inner", 8, None), ("open", 8, None)]
    assert rec.spans[0][3:] == (0, 50) and rec.spans[3][3:] == (60, 70)
    assert set(totals) == {"outer", "inner"}  # an open span is not counted
    assert totals["outer"] == pytest.approx(profiling.Total(1, 50e-9, 30e-9), abs=1e-15)
    assert totals["inner"].count == 3 and totals["inner"].total_s == pytest.approx(30e-9)
    assert totals["inner"].self_s == totals["inner"].total_s
    assert rec.totals(since=3)["inner"] == pytest.approx(profiling.Total(1, 10e-9, 10e-9),
                                                         abs=1e-15)


def test_app_drag_and_frame_record_each_layer_in_its_nesting(scene):
    app = _app(scene)
    app.render()
    with profiling.recording() as rec:
        app.drag(3.0, -2.0)
        app.render()
    names = [s[0] for s in rec.spans]
    assert [n for n in names if n in FRAME] == FRAME and "engine.jitter" not in names
    by_name = {s[0]: s for s in rec.spans}
    top = {n for n, _, parent, _, _ in rec.spans if parent is None}
    assert top == {"app.drag", "app.frame_params", "engine.frame", "app.copy"}
    for name in INSIDE_FRAME:
        assert rec.spans[by_name[name][2]][0] == "engine.frame", name
    assert {s[1] for s in rec.spans} == {app.frames} == {2}
    totals = rec.totals()
    frame = totals["engine.frame"]
    assert frame.self_s == pytest.approx(
        frame.total_s - sum(totals[n].total_s for n in INSIDE_FRAME), abs=1e-9)
    assert all(t.count == 1 for t in totals.values())


def test_device_trace_holds_the_frame_spans(scene, tmp_path):
    app = _app(scene)
    with profiling.device_trace(str(tmp_path)):
        app.drag(2.0, 1.0)
        app.render()
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    assert {e["name"] for e in ranges} >= set(FRAME)
    frame = next(e for e in ranges if e["name"] == "engine.frame")
    for e in ranges:
        if e["name"] in INSIDE_FRAME:
            assert frame["ts"] <= e["ts"] and e["ts"] + e["dur"] <= frame["ts"] + frame["dur"]


def test_renderer_construction_records_pack_then_upload(scene):
    _, data, sky = scene
    with profiling.recording() as rec:
        Renderer(data, sky, device="cpu")
    assert [(n, p) for n, _, p, _, _ in rec.spans] == [("renderer.pack", None),
                                                         ("pack.collapse:sah-native", 0),
                                                         ("renderer.upload", None)]
    assert rec.totals()["renderer.pack"].total_s > 0.0


@pytest.mark.parametrize("route", ["object", "object-native", "sbvh", "sbvh-native"])
def test_the_scene_build_is_one_span_of_its_route(route):
    """``make_world``'s build is one ``world.bvh:<route>`` span, reinsertion
    inside it, and ``get_shader_data`` one ``world.shader_data`` span."""
    from shader_ray_tpu_torch.config import Config

    splits, _, how = route.partition("-")
    cfg = Config(splits=splits, use_native="require" if how else "never")
    ts = TriangleSet.from_arrays(*uv_sphere(lat=6, lon=8))
    with profiling.recording() as rec:
        world = make_world(ts, cfg)
        get_shader_data(world, cfg)
    assert [(n, p) for n, _, p, _, _ in rec.spans] == [(f"world.bvh:{route}", None),
                                                         ("world.shader_data", None)]
    assert world.counts.route == route and world.counts.references == len(world.tri_order)
    assert "world.bvh" in profiling.SPANS and "world.shader_data" in profiling.SPANS
    if not how:
        with profiling.recording() as rec:
            make_world(ts, Config(splits=splits, bvh_opt="reinsert", use_native="require"))
        assert [s[0] for s in rec.spans] == [f"world.bvh:{route}"]


def test_kernel_library_build_and_load_are_spans(monkeypatch, tmp_path):
    class Nvcc:
        """An nvcc that writes its output file and succeeds."""

        def __init__(self, argv, **kw):
            open(argv[argv.index("-o") + 1], "wb").close()
            self.returncode = 0

        def communicate(self):
            return "", "ptxas info: fake\n"

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    load = _build.library.__wrapped__
    with profiling.recording() as rec:
        lib, report = load("env_kernel")
        load("env_kernel")  # built: loaded only
    assert [s[0] for s in rec.spans] == ["kernels.build:env_kernel", "kernels.load:env_kernel",
                                         "kernels.load:env_kernel"]
    assert lib.startswith(str(tmp_path)) and "fake" in report
