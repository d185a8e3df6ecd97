"""The frame kernel's given-rays form, the fused ``which = 5`` frame and
lane retirement (``min_contrib``), on the CPU through the plain version
(``frame_plain``) and ``Renderer(device="cpu")``.

Given rays: the raygen rays handed in give the raygen frame (mean abs
<= 1e-6 on linear colour, the counter row equal; built independently by
``ops/render.rays_for_pixels``, so they differ from the kernel's raygen
in f32 op order).  The fused ``which = 5`` frame is held to the
wavefront engine's supersample oracle (the reference's ``trace_rays`` over
the 25 sub-sample rays) at the frame tolerance of
tests/test_torch_unfused.py (mean abs < 2e-3, >= 99% of pixels within
2e-2, tonemapped) and to the port's unfused ``which = 5`` frame (mean abs
<= 1e-6 linear: the same walks, f32 op order in shading).

``min_contrib``: the JAX package computes it only inside its Pallas
kernel, which the interpreter runs too slowly for this suite, so it is
pinned by what it must equal.  At 0 nothing changes; at 1.0 every hit
lane retires after bounce 0 (no modulation component of a specular
colour <= 1 exceeds 1), so the frame is the ``bounce_count = 1`` frame
exactly, which is held to the wavefront engine at ``bounce_count = 1``;
at 0.004 and 0.2 the rays cast do not rise with the threshold and the
colour stays within 3 x min_contrib of the exact frame (the bound of the
reference's tests/test_fused.py), on the bunny-class scene of
chip_smoke's min-contrib cases, where reflected rays hit again."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models.fixtures import procedural_sky, uv_sphere
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.models.world import get_shader_data, make_world
from shader_ray_tpu.ops.render import RenderStatics as RefStatics
from shader_ray_tpu.ops.render import default_frame_params as ref_default_params
from shader_ray_tpu.ops.render import generate_rays as ref_generate_rays
from shader_ray_tpu.ops.render import render_frame as ref_render_frame
from shader_ray_tpu.ops.render import trace_rays as ref_trace_rays
from shader_ray_tpu.ops.scene import upload_scene
from shader_ray_tpu.ops.shading import Rays as RefRays
from shader_ray_tpu.ops.shading import tonemap_and_gamma as ref_tonemap
from shader_ray_tpu.utils import mat4 as ref_mat4
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.convert import frame_params_from_numpy, scene_data_from_numpy
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.ops import engine_frame
from shader_ray_tpu_torch.ops import frame_kernel as fk
from shader_ray_tpu_torch.ops.render import RenderStatics, rays_for_pixels
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZE = 24  # the which = 5 frames
N = 48


def assert_frame_close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.mean() < 2e-3, err.mean()
    assert (err.max(axis=-1) <= 2e-2).mean() >= 0.99, (err.max(axis=-1) > 2e-2).mean()


@pytest.fixture(scope="module")
def sphere():
    """The sphere fixture of tests/test_torch_unfused.py: smooth normals,
    diffuse red with shadows under a tilted light, 30% specular."""
    pos, nrm = uv_sphere(lat=12, lon=16)
    cfg = RefConfig()
    cfg.use_native = "never"
    ref = get_shader_data(make_world(RefTriangleSet.from_arrays(pos, nrm), cfg), cfg)
    env = procedural_sky(1024)
    jp = ref_default_params()._replace(
        camera_matrix=jnp.asarray(ref_mat4.make_translation(0.0, 0.0, 3.2)),
        light_dir=jnp.asarray(np.array([0.36, 0.48, 0.8], np.float32)),
        diffuse_color=jnp.asarray(np.array([0.8, 0.2, 0.2], np.float32)),
        specular_color=jnp.asarray(np.array([0.3, 0.3, 0.3], np.float32)),
    )
    tp = frame_params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()})
    data = scene_data_from_numpy(vars(ref))
    renderers = {
        "fused": Renderer(data, env, device="cpu"),
        "unfused": Renderer(data, env, Config(packet_fused=False), device="cpu"),
    }
    return upload_scene(ref, env), jp, tp, renderers


@pytest.mark.parametrize("which,aniso", [(0, 1), (1, 4), (2, 1)])
def test_given_raygen_rays_give_the_raygen_frame(sphere, which, aniso):
    _, _, tp, renderers = sphere
    packed = renderers["fused"].packed
    uni = engine_frame.pack_uniforms(tp)
    jit = torch.from_numpy(engine_frame.halton_jitters(2))
    fs = fk.FrameSettings(width=N, height=N, which=which, env_aniso=aniso)
    want, want_n = fk.frame_plain(packed, uni, jit, fs)
    # the kernel's own raygen rays, handed in: the same frame, bit for bit
    got, got_n = fk.frame_plain(packed, uni, None, fs, rays=fk.raygen_rays(uni, jit, fs))
    assert torch.equal(got, want) and torch.equal(got_n, want_n)
    # the same rays built by the unfused engine's raygen
    jj = torch.arange(N, dtype=torch.float32)[:, None]
    ii = torch.arange(N, dtype=torch.float32)[None, :]
    sets = [rays_for_pixels(RenderStatics(width=N, height=N), tp._replace(pixel_jitter=j), jj, ii)[0]
            for j in jit]
    given = fk.GivenRays(sets[0].P.contiguous(), *(torch.stack([getattr(r, f) for r in sets])
                                                   for f in ("D", "dDdx", "dDdy")))
    got, got_n = fk.frame_plain(packed, uni, None, fs, rays=given)
    assert float((got - want).abs().mean()) <= 1e-6
    assert torch.equal(got_n, want_n)


def test_given_rays_are_checked(sphere):
    _, _, tp, renderers = sphere
    packed = renderers["fused"].packed
    block = engine_frame.fill_uniforms(np.zeros(fk.UNI_BLOCK, np.float32), tp)
    fs = fk.FrameSettings(width=4, height=4, which=1)
    rays = fk.GivenRays(torch.zeros((16, 3)), torch.ones((2, 16, 3)))
    with pytest.raises(ValueError, match="either jitters"):
        fk.frame_kernel(packed, block, torch.zeros((1, 2)), fs, rays=rays)
    with pytest.raises(ValueError, match="dDdx"):  # a grad mode reads the differentials
        fk.frame_kernel(packed, block, None, fs, rays=rays)
    with pytest.raises(ValueError, match="rays.D"):
        fk.frame_kernel(packed, block, None, fs._replace(which=0),
                        rays=rays._replace(D=torch.ones((2, 15, 3))))


@pytest.fixture(scope="module")
def supersample_oracle(sphere):
    """(24, 24, 3) tonemapped which=5 frame of the wavefront engine,
    specular only (tests/test_torch_unfused.py builds it so)."""
    scene, jp, _, _ = sphere
    n = 5
    statics = RefStatics(width=SIZE, height=SIZE, which=5, enable_diffuse=False,
                         tile_size=SIZE * SIZE)
    rays, (right, up) = ref_generate_rays(statics, jp)
    trace = jax.jit(lambda sc, r: ref_trace_rays(sc, r, jp, statics))
    acc = jnp.zeros_like(rays.P)
    for i in range(n):
        for j in range(n):
            D = rays.D + (i / n - 0.5) * 0.2 * right + (j / n - 0.5) * 0.2 * up
            D = D / jnp.linalg.norm(D, axis=-1, keepdims=True)
            zero = jnp.zeros_like(D)
            sub = RefRays(P=rays.P, D=D, dPdx=zero, dDdx=right - (D @ right)[:, None] * D,
                          dPdy=zero, dDdy=up - (D @ up)[:, None] * D)
            acc = acc + trace(scene, sub)
    return np.asarray(ref_tonemap(acc / (n * n), True)).reshape(SIZE, SIZE, 3)


def test_fused_which5_is_one_given_rays_launch(sphere, supersample_oracle, monkeypatch):
    _, _, tp, renderers = sphere
    calls = []

    def recorded(packed, uni, jitters, fs, tile_rows=None, rays=None):
        calls.append((jitters, fs, rays))
        return fk.frame_kernel(packed, uni, jitters, fs, tile_rows, rays)

    def no_trace(*args, **kw):
        raise AssertionError("the fused which=5 frame ran the unfused engine")

    monkeypatch.setattr(engine_frame, "frame_kernel", recorded)
    monkeypatch.setattr(engine_frame, "trace_rays", no_trace)
    st = RenderStatics(width=SIZE, height=SIZE, which=5, enable_diffuse=False)
    got = renderers["fused"].make_fn(st)(tp).numpy()
    (jitters, fs, rays), = calls
    assert jitters is None and rays.D.shape == (25, SIZE * SIZE, 3) and rays.P.shape == (SIZE * SIZE, 3)
    assert (fs.which, fs.mode()) == (0, "bilinear")  # with_grads is off at which=5, as the reference's
    assert got.shape == (SIZE, SIZE, 3) and np.isfinite(got).all()
    assert_frame_close(got, supersample_oracle)


@pytest.mark.parametrize("diffuse", [False, True])
def test_fused_which5_matches_the_unfused_frame(sphere, diffuse):
    _, _, tp, renderers = sphere
    st = RenderStatics(width=SIZE, height=SIZE, which=5, enable_diffuse=diffuse, do_tonemap=False)
    fused = renderers["fused"].make_fn(st)(tp)
    unfused = renderers["unfused"].make_fn(st)(tp)
    assert float((fused - unfused).abs().mean()) <= 1e-6
    # the 25 sub-samples soften the silhouette: not the 1-sample frame
    one = renderers["fused"].make_fn(st._replace(which=0))(tp)
    assert float((fused - one).abs().max()) > 0.05


def test_fused_which5_progressive_is_mean_of_frames(sphere):
    _, _, tp, renderers = sphere
    r = renderers["fused"]
    st = RenderStatics(width=SIZE, height=SIZE, which=5, do_tonemap=False)
    prog = r.make_progressive_fn(st, 2)(tp)
    frame = r.make_fn(st)
    frames = [frame(tp._replace(pixel_jitter=torch.from_numpy(j)))
              for j in engine_frame.halton_jitters(2)]
    torch.testing.assert_close(prog, (frames[0] + frames[1]) / 2, rtol=1e-6, atol=1e-7)
    assert not torch.equal(frames[0], frames[1])


def test_count_at_which5_is_the_which0_count(sphere):
    _, _, tp, renderers = sphere
    st = RenderStatics(width=N, height=N)
    for name in ("fused", "unfused"):
        count = renderers[name].make_count_fn
        assert count(st._replace(which=5))(tp) == count(st)(tp), name


@pytest.fixture(scope="module")
def wavefront_frame(sphere):
    scene, jp, _, _ = sphere
    frames = {}

    def frame(**kw):
        key = tuple(sorted(kw.items()))
        if key not in frames:
            statics = RefStatics(tile_size=kw["width"] * kw["height"], **kw)
            frames[key] = np.asarray(jax.jit(lambda s, p: ref_render_frame(s, p, statics))(scene, jp))
        return frames[key]

    return frame


def test_min_contrib_zero_changes_nothing(sphere, wavefront_frame):
    _, _, tp, renderers = sphere
    r = renderers["fused"]
    st = RenderStatics(width=N, height=N, do_tonemap=False)
    assert r.cfg.min_contrib == 0.0 and Config().min_contrib == 0.0
    fs = fk.FrameSettings(width=N, height=N)
    want, want_n = fk.frame_plain(r.packed, engine_frame.pack_uniforms(tp), torch.zeros((1, 2)), fs)
    assert torch.equal(r.make_fn(st)(tp), want)
    assert r.make_count_fn(st)(tp) == int(want_n[0])
    assert_frame_close(r.make_fn(st._replace(do_tonemap=True))(tp).numpy(),
                       wavefront_frame(width=N, height=N))


def test_min_contrib_one_is_the_one_bounce_frame(sphere, wavefront_frame):
    """Every hit lane retires after bounce 0, so the 3-bounce frame is the
    ``bounce_count = 1`` frame, colour and rays cast, exactly."""
    _, _, tp, renderers = sphere
    r = renderers["fused"]
    st = RenderStatics(width=N, height=N, do_tonemap=False)
    one = st._replace(bounce_count=1)
    r.cfg.min_contrib = 1.0
    try:
        cut, cast_cut = r.make_fn(st)(tp), r.make_count_fn(st)(tp)
    finally:
        r.cfg.min_contrib = 0.0
    assert torch.equal(cut, r.make_fn(one)(tp))
    assert cast_cut == r.make_count_fn(one)(tp) < r.make_count_fn(st)(tp)
    assert not torch.equal(cut, r.make_fn(st)(tp))  # the bounces it cut did show
    assert_frame_close(r.make_fn(one._replace(do_tonemap=True))(tp).numpy(),
                       wavefront_frame(width=N, height=N, bounce_count=1))


def test_min_contrib_cuts_work_within_its_bound():
    """On chip_smoke's min-contrib scene (specular 0.05, reflections that
    hit again): rays cast fall as the threshold rises, and the colour
    stays within 3 x min_contrib of the exact frame."""
    packed, uni, jit, fs, _ = chip_smoke.frame_case("min-contrib-0.2", torch.device("cpu"))
    exact, exact_n = fk.frame_plain(packed, uni, jit, fs._replace(min_contrib=0.0))
    cast = [int(exact_n[0])]
    for mc in (0.004, 0.2):
        colour, counters = fk.frame_plain(packed, uni, jit, fs._replace(min_contrib=mc))
        assert float((colour - exact).abs().max()) <= 3 * mc
        cast.append(int(counters[0]))
    assert cast[0] > cast[1] > cast[2], cast
