"""The frame kernel's launch cache and host block (ops/frame_kernel.
_launch_for, ops/engine_frame.fill_uniforms) on the CPU route: the block
holds ``pack_uniforms``' table bit for bit and the frame's jitter; the
tables keep one entry a settings value over a session's frames and build
another when the settings change (a knob set on the App, a tune,
``min_contrib`` set on a Renderer used alone), every route the frame
functions' and the sharded bands' included; an entry lives and dies with
its tables and the cache is bounded; and the frames, counts and tile
rows of the routes equal ``frame_plain`` on ``pack_uniforms`` and a
(1, 2) jitter table, or the progressive function's Halton table.  The
card's form of the same launch is
``test_planned_launch_matches_plain_on_card`` in
tests/test_torch_isolation.py."""

import dataclasses
import gc
import io
import weakref

import numpy as np
import pytest
import torch

from shader_ray_tpu_torch.app.driver import App
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.models.fixtures import procedural_sky, uv_sphere
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.ops import _build
from shader_ray_tpu_torch.ops import engine_frame as ef
from shader_ray_tpu_torch.ops import frame_kernel as fk
from shader_ray_tpu_torch.ops.render import FrameParams, RenderStatics, default_frame_params
from shader_ray_tpu_torch.utils import mat4
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 8  # frames of N x N pixels: the plain version's time is the tests' time


@pytest.fixture(scope="module")
def scene():
    pos, nrm = uv_sphere(lat=6, lon=8)
    world = make_world(TriangleSet.from_arrays(pos, nrm))
    params = default_frame_params()._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0.0, 0.0, 3.2)),
        diffuse_color=torch.tensor([0.8, 0.2, 0.2]),
        pixel_jitter=torch.tensor([0.25, -0.375]),
    )
    return world, procedural_sky(32), params


def _params_cases():
    rng = np.random.default_rng(17)
    mats = lambda: [rng.normal(size=(4, 4)) for _ in range(5)]
    vecs = lambda: [rng.normal(size=3) for _ in range(3)]
    # float64 numpy values, rounded to f32 by both packers
    f64 = FrameParams(*mats(), *vecs(), float(rng.uniform(0.2, 2.0)), rng.normal(size=2))
    # f32 tensors, no jitter
    f32 = FrameParams(*[torch.from_numpy(x.astype(np.float32)) for x in (*mats(), *vecs())],
                      torch.tensor(0.7279404), None)
    return {"default": default_frame_params(), "float64 arrays": f64, "f32 tensors": f32,
            "app": None}


@pytest.mark.parametrize("case", list(_params_cases()))
def test_host_block_is_pack_uniforms(case, scene):
    """``fill_uniforms`` writes ``pack_uniforms``' table bit for bit, then
    the frame's jitter ((0, 0) without one), over a block that held
    another frame's values."""
    params = _params_cases()[case]
    if params is None:
        world, sky, _ = scene
        app = App(world, Renderer(get_shader_data(world), sky, device="cpu"), width=N, height=N)
        app.drag(12.0, -7.0)
        params = app.frame_params()._replace(pixel_jitter=torch.tensor([-0.125, 0.4375]))
    block = np.full(fk.UNI_BLOCK, np.nan, np.float32)
    assert ef.fill_uniforms(block, params) is block
    want = ef.pack_uniforms(params).numpy()
    assert np.array_equal(block[:fk.UNI_SIZE].view(np.uint32), want.view(np.uint32))
    assert np.array_equal(block[fk.UNI_JITTER:], ef.frame_jitter(params).numpy().reshape(2))


def _plans() -> int:
    return _build.PLANS["built"]


def test_a_frame_function_keeps_its_plan(scene, monkeypatch):
    """One cache entry over 50 App frames, each frame its own drag; a new
    one after ``set_knob("frame_tile", ...)``, after a ``tune`` picks
    another shape, and when ``min_contrib`` changes on a Renderer used
    without the App; none when the knobs return to settings seen
    before."""
    world, sky, _ = scene
    renderer = Renderer(get_shader_data(world), sky, device="cpu")
    app = App(world, renderer, width=N, height=N)
    before = _plans()
    for i in range(50):
        app.drag(float(i % 7) - 3.0, 0.5 * (i % 3))
        app.draw_frame()
    assert _plans() == before + 1
    assert app.set_knob("frame_tile", "32", file=io.StringIO())
    app.draw_frame()
    app.draw_frame()
    assert _plans() == before + 2
    import shader_ray_tpu_torch.utils.autotune as autotune

    def tuned(renderer, *args, **kw):  # the search's winner, applied as autotune applies it
        best = {"frame_tile": 8, "frame_warp": "bricks"}
        for k, v in best.items():
            setattr(renderer.cfg, k, v)
        return best, {}

    monkeypatch.setattr(autotune, "autotune", tuned)
    app.tune(samples=2, file=io.StringIO())
    app.draw_frame()
    assert _plans() == before + 3
    assert app.set_knob("frame_tile", "16", file=io.StringIO())
    assert app.set_knob("frame_warp", "rows", file=io.StringIO())
    app.draw_frame()
    assert _plans() == before + 3

    alone = Renderer(get_shader_data(world), sky, device="cpu")
    statics = RenderStatics(width=N, height=N)
    fn = alone.make_fn(statics)
    params = app.frame_params()
    fn(params)
    fn(params)
    assert _plans() == before + 4
    alone.cfg.min_contrib = 0.5
    got = fn(params)
    assert _plans() == before + 5
    fs = ef.frame_settings(statics, Config(min_contrib=0.5))
    want = ef.finish(fk.frame_plain(alone.packed, ef.pack_uniforms(params),
                                    ef.frame_jitter(params), fs)[0], statics)
    assert torch.equal(got, want)


ROUTES = ["which=0", "which=1", "which=5", "progressive K=4", "count", "stats"]


@pytest.mark.parametrize("route", ROUTES)
def test_planned_routes_equal_the_unplanned_frames(route, scene):
    """Bit for bit ``frame_plain`` on ``pack_uniforms`` with a (1, 2)
    jitter table (or K = 4 Halton jitters, or the 25 given sub-ray sets),
    twice through one frame function, which builds one cache entry."""
    world, sky, params = scene
    r = Renderer(get_shader_data(world), sky, device="cpu")
    which = int(route[6]) if route.startswith("which") else 0
    statics = RenderStatics(width=N, height=N, which=which, env_aniso=4 if which == 1 else 1)
    fs = ef.frame_settings(statics, Config())
    uni, jit = ef.pack_uniforms(params), ef.frame_jitter(params)
    if route == "progressive K=4":
        fn = r.make_progressive_fn(statics, 4)
        want = ef.finish(fk.frame_plain(r.packed, uni, torch.from_numpy(ef.halton_jitters(4)),
                                        fs)[0], statics)
    elif route == "count":
        fn = r.make_count_fn(statics)
        want = int(fk.frame_plain(r.packed, uni, jit, fs)[1][0])
    elif route == "stats":
        fn = r.make_stats_fn(statics)
        want = torch.empty((fs.n_tiles(), 1 + 3 * fs.phases()), dtype=torch.long)
        fk.frame_plain(r.packed, uni, jit, fs, tile_rows=want)
    elif which == 5:
        fn = r.make_fn(statics)
        rays, (right, up) = ef.primary_rays(statics, params)
        given = fk.GivenRays(rays.P.contiguous(), ef.supersample_directions(rays.D, right, up))
        want = ef.finish(fk.frame_plain(r.packed, uni, None, fs, rays=given)[0], statics)
    else:
        fn = r.make_fn(statics)
        want = ef.finish(fk.frame_plain(r.packed, uni, jit, fs)[0], statics)
    before = _plans()
    for _ in range(2):
        got = fn(params)
        assert got == want if route == "count" else torch.equal(got, want)
    assert _plans() == before + 1


def test_frame_kernel_refuses_a_malformed_block(scene):
    world, sky, params = scene
    packed = Renderer(get_shader_data(world), sky, device="cpu").packed
    fs = fk.FrameSettings(width=N, height=N)
    block = ef.fill_uniforms(np.zeros(fk.UNI_BLOCK, np.float32), params)
    # a short block, another dtype, and the (UNI_SIZE,) table as a tensor
    for bad in (block[:fk.UNI_SIZE], block.astype(np.float64), ef.pack_uniforms(params)):
        with pytest.raises(ValueError, match="host block"):
            fk.frame_kernel(packed, bad, None, fs)
        with pytest.raises(ValueError, match="host block"):
            fk.frame_kernel(packed, bad, ef.frame_jitter(params), fs)
    colour, row = fk.frame_kernel(packed, block, None, fs)
    want = fk.frame_plain(packed, ef.pack_uniforms(params), ef.frame_jitter(params), fs)
    assert torch.equal(colour, want[0]) and torch.equal(row, want[1])


@pytest.mark.parametrize("route", ["which=0", "which=5", "stats"])
def test_a_route_without_a_plan_builds_none(route, scene):
    """Routes called outside a frame function share its cache: the
    sharded bands of a ``which = 0`` frame (two bands of one height on
    one replica), and the ``which = 5`` and stats routes called beside
    their frame functions, build one entry and then launch through it.
    Their frames are the frame functions' (the bands': the whole frame's
    given-rays form, as tests/test_torch_parallel.py holds them)."""
    world, sky, params = scene
    data = get_shader_data(world)
    which = int(route[6]) if route.startswith("which") else 0
    statics = RenderStatics(width=N, height=N, which=which, do_tonemap=False)
    r = Renderer(data, sky, device="cpu")
    if route == "which=0":
        want = ef.render_linear(r.packed, params, statics, ef.frame_jitter(params), Config(),
                                rows=(0, N))
        fn = Renderer(data, sky, mesh=["cpu", "cpu"]).make_fn(statics)
        calls = [fn, fn]
    elif route == "stats":
        want = ef.tile_stats(Renderer(data, sky, device="cpu").packed, params, statics, Config())
        calls = [lambda p: ef.tile_stats(r.packed, p, statics, r.cfg), r.make_stats_fn(statics)]
    else:
        want = ef.render_frame(Renderer(data, sky, device="cpu").packed, params, statics, Config())
        calls = [lambda p: ef.render_frame(r.packed, p, statics, r.cfg), r.make_fn(statics)]
    before = _plans()
    for call in calls * 2:
        assert torch.equal(call(params), want)
    assert _plans() == before + 1


def test_a_dropped_renderer_leaves_no_entry(scene):
    """An entry holds no tensor: the tables go with their Renderer, and
    with them the entries.  A new ``PackedWide`` (another Renderer of the
    same scene, a ``dataclasses.replace``) starts with none and builds
    its own; the cache holds at most ``MAX_LAUNCHES`` settings, dropping
    the oldest."""
    world, sky, params = scene
    data = get_shader_data(world)
    statics = RenderStatics(width=N, height=N)
    r = Renderer(data, sky, device="cpu")
    fn = r.make_fn(statics)
    fn(params)
    (entry,) = r.packed.launches.values()
    dropped, tables = weakref.ref(r.packed), weakref.ref(r.packed.nodes)
    fresh = Renderer(data, sky, device="cpu")
    assert not fresh.packed.launches and not dataclasses.replace(r.packed).launches
    before = _plans()
    fresh.make_fn(statics)(params)
    assert _plans() == before + 1 and len(fresh.packed.launches) == 1
    del r, fn
    gc.collect()
    assert dropped() is None and tables() is None and entry.device.type == "cpu"

    fs = ef.frame_settings(statics, Config())
    first = fk._launch_for(fresh.packed, fs)
    for i in range(1, fk.MAX_LAUNCHES + 1):
        fk._launch_for(fresh.packed, fs._replace(min_contrib=i / 64))
    assert len(fresh.packed.launches) == fk.MAX_LAUNCHES and fs not in fresh.packed.launches
    assert fk._launch_for(fresh.packed, fs) is not first
