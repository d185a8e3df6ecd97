"""The unfused path as a whole on ``Renderer(device="cpu")`` (plain
versions of the trace and env kernels): frames for ``which`` 0, 1 (with
``env_aniso = 4``; tests/test_torch_envgrad.py holds the lookup itself
for 1 and 4), 2, 3 and 5, over the 8-wide and the binary tables, against the reference's
wavefront engine (``ops/render.render_frame``) on the sphere fixture;
the ``which = 0`` frame against the port's own fused plain frame; and
the cast-ray count on both routes.

Frame tolerance against the wavefront engine: mean abs < 2e-3 and >= 99%
of pixels within 2e-2 on the 0-1 tonemapped scale (``which = 2, 3`` are
compared untonemapped, where the same numbers bound |du|, |dv| x 100).
No exact match is expected: the wide walk tests leaves with the Woop
affine and the reference with Moller-Trumbore, so t and the barycentrics
round differently and a grazing ray can flip between hit and miss.
The ``which = 5`` oracle is the mean of the reference's ``trace_rays``
over the 25 sub-sample rays, built as ``ops/render._render_tile`` builds
them (fs:654-673) and traced in one jitted call as one batch of 25 x
W x H rays: the reference's own eager loop recompiles its six traversals
for each of the 25 sub-frames and takes a minute.
``which = 1`` is held to the oracle's deeper mip chain (down to 1 x 1;
the port's pyramid stops at height 16): with a 512 x 1024 sky only
silhouette-grazing reflections have a lod past the port's last level,
inside the 1% of pixels the tolerance leaves free.

Unfused against fused (the port's own two routes, same tables, same
walk): mean abs <= 1e-6 on linear colour — they differ only in the
order of f32 operations in raygen and shading."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models.fixtures import procedural_sky, uv_sphere
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.models.world import get_shader_data, make_world
from shader_ray_tpu.ops.render import RenderStatics as RefStatics
from shader_ray_tpu.ops.render import default_frame_params as ref_default_params
from shader_ray_tpu.ops.render import generate_rays as ref_generate_rays
from shader_ray_tpu.ops.render import render_frame as ref_render_frame
from shader_ray_tpu.ops.render import trace_rays as ref_trace_rays
from shader_ray_tpu.ops.shading import Rays as RefRays
from shader_ray_tpu.ops.shading import tonemap_and_gamma as ref_tonemap
from shader_ray_tpu.ops.scene import upload_scene
from shader_ray_tpu.utils import mat4 as ref_mat4
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.convert import frame_params_from_numpy, scene_data_from_numpy
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.ops import engine_frame
from shader_ray_tpu_torch.ops.pack import PackedBinary
from shader_ray_tpu_torch.ops.pack_wide import PackedWide
from shader_ray_tpu_torch.ops.render import RenderStatics
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 64
CONFIGS = {
    "wide": Config(packet_fused=False),
    "binary": Config(packet_kernel="binary"),
}


def assert_frame_close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.mean() < 2e-3, err.mean()
    assert (err.max(axis=-1) <= 2e-2).mean() >= 0.99, (err.max(axis=-1) > 2e-2).mean()


@pytest.fixture(scope="module")
def sphere():
    """The sphere fixture with smooth normals, diffuse red with shadows
    under a tilted light, 30% specular so the env term shows."""
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
    renderers = {k: Renderer(data, env, cfg, device="cpu") for k, cfg in CONFIGS.items()}
    renderers["fused"] = Renderer(data, env, device="cpu")
    return upload_scene(ref, env), jp, tp, renderers


@pytest.fixture(scope="module")
def wavefront_frame(sphere):
    """``frame(**statics) -> (H, W, 3)`` of the wavefront engine, kept
    per configuration: both table types are held to the same frame."""
    scene, jp, _, _ = sphere
    frames = {}

    def frame(**kw):
        key = tuple(sorted(kw.items()))
        if key not in frames:
            # jitted: eager, render_frame dispatches its while-loops op by op
            statics = RefStatics(tile_size=kw["width"] * kw["height"], **kw)
            frames[key] = np.asarray(jax.jit(lambda s, p: ref_render_frame(s, p, statics))(scene, jp))
        return frames[key]

    return frame


@pytest.fixture(scope="module")
def supersample_oracle(sphere):
    """(24, 24, 3) tonemapped which=5 frame of the wavefront engine,
    specular only (as tests/test_render.py renders this mode)."""
    scene, jp, _, _ = sphere
    size, n = 24, 5
    statics = RefStatics(width=size, height=size, which=5, enable_diffuse=False,
                         tile_size=size * size)

    @jax.jit
    def oracle(sc, p):
        rays, (right, up) = ref_generate_rays(statics, p)
        sets = []
        for i in range(n):
            for j in range(n):
                D = rays.D + (i / n - 0.5) * 0.2 * right + (j / n - 0.5) * 0.2 * up
                D = D / jnp.linalg.norm(D, axis=-1, keepdims=True)
                sets.append((D, right - (D @ right)[:, None] * D, up - (D @ up)[:, None] * D))
        D, dDdx, dDdy = (jnp.concatenate(x) for x in zip(*sets))
        zero = jnp.zeros_like(D)
        sub = RefRays(P=jnp.tile(rays.P, (n * n, 1)), D=D, dPdx=zero, dDdx=dDdx, dPdy=zero,
                      dDdy=dDdy)
        colour = ref_trace_rays(sc, sub, p, statics).reshape(n * n, -1, 3)
        return ref_tonemap(colour.mean(axis=0), True)

    return np.asarray(oracle(scene, jp)).reshape(size, size, 3)


def test_renderer_packs_by_config(sphere):
    _, _, _, renderers = sphere
    assert isinstance(renderers["wide"].packed, PackedWide) and not renderers["wide"].cfg.packet_fused
    assert isinstance(renderers["binary"].packed, PackedBinary)
    assert isinstance(renderers["fused"].packed, PackedWide) and renderers["fused"].cfg.packet_fused
    st = RenderStatics(width=N, height=N)
    assert st.env_aniso == 1  # isotropic unless asked, as the reference's statics
    assert RenderStatics.from_config(Config(), width=N, which=1) == \
        RenderStatics(width=N, which=1, env_aniso=4)
    route = engine_frame.fused_route
    on, off = Config(), Config(packet_fused=False)
    assert route(renderers["fused"].packed, st, on)
    assert not route(renderers["fused"].packed, st, off)
    assert not route(renderers["binary"].packed, st, on)
    # which 1 and 2 run the fused kernel's with_grads form and 5 its
    # given-rays form in the bilinear mode, as the reference's fused
    # kernel does; 3 (no trace) keeps the unfused route
    for which in (1, 2, 5):
        assert route(renderers["fused"].packed, st._replace(which=which), on)
        assert not route(renderers["fused"].packed, st._replace(which=which), off)
        assert not route(renderers["binary"].packed, st._replace(which=which), on)
        fs = engine_frame.frame_settings(st._replace(which=which, env_aniso=4), on)
        assert (fs.which, fs.env_aniso) == (0 if which == 5 else which, 4)
    assert not route(renderers["fused"].packed, st._replace(which=3), on)
    with pytest.raises(NotImplementedError, match="unfused_linear"):
        engine_frame.frame_settings(st._replace(which=3), on)


@pytest.mark.parametrize("tables", sorted(CONFIGS))
@pytest.mark.parametrize("which,aniso,size,tonemap", [
    (0, 1, N, True),
    (1, 4, N, True),
    (2, 1, N, False),
    (3, 1, N, False),
])
def test_unfused_frame_matches_wavefront_engine(
    sphere, wavefront_frame, tables, which, aniso, size, tonemap
):
    _, _, tp, renderers = sphere
    kw = dict(width=size, height=size, which=which, env_aniso=aniso, do_tonemap=tonemap)
    want = wavefront_frame(**kw)
    got = renderers[tables].make_fn(RenderStatics(**kw))(tp).numpy()
    assert got.shape == (size, size, 3) and np.isfinite(got).all()
    assert_frame_close(got, want)
    assert got.std() > 1e-3  # a picture, not a constant


@pytest.mark.parametrize("tables", sorted(CONFIGS))
def test_supersample_frame_matches_wavefront_engine(sphere, supersample_oracle, tables):
    _, _, tp, renderers = sphere
    st = RenderStatics(width=24, height=24, which=5, enable_diffuse=False)
    got = renderers[tables].make_fn(st)(tp).numpy()
    assert got.shape == (24, 24, 3) and np.isfinite(got).all()
    assert_frame_close(got, supersample_oracle)
    # the 25 sub-samples soften the silhouette: not the 1-sample frame
    one = renderers[tables].make_fn(st._replace(which=0))(tp).numpy()
    assert np.abs(got - one).max() > 0.05


@pytest.mark.parametrize("tables", sorted(CONFIGS))
def test_unfused_matches_fused_plain_frame(sphere, tables):
    _, _, tp, renderers = sphere
    linear = RenderStatics(width=N, height=N, do_tonemap=False)
    fused = renderers["fused"].make_fn(linear)(tp)
    unfused = renderers[tables].make_fn(linear)(tp)
    assert float((fused - unfused).abs().mean()) <= 1e-6
    toned = RenderStatics(width=N, height=N)
    assert float(renderers[tables].make_checksum_fn(toned)(tp)) == pytest.approx(
        float(renderers["fused"].make_fn(toned)(tp).sum()), rel=1e-5)


@pytest.mark.parametrize("tables", sorted(CONFIGS))
def test_count_equal_on_both_routes(sphere, tables):
    _, _, tp, renderers = sphere
    st = RenderStatics(width=N, height=N)
    fused = renderers["fused"].make_count_fn(st)(tp)
    assert N * N < fused <= 6 * N * N
    assert renderers[tables].make_count_fn(st)(tp) == fused
    # a debug mode counts one trace of its primary rays
    assert renderers[tables].make_count_fn(st._replace(which=1))(tp) == fused


@pytest.mark.parametrize("tables", sorted(CONFIGS))
def test_unfused_progressive_is_mean_of_frames(sphere, tables):
    _, _, tp, renderers = sphere
    r = renderers[tables]
    linear = RenderStatics(width=32, height=32, do_tonemap=False, which=1, env_aniso=4)
    prog = r.make_progressive_fn(linear, 2)(tp)
    frame = r.make_fn(linear)
    jit = engine_frame.halton_jitters(2)
    frames = [frame(tp._replace(pixel_jitter=torch.from_numpy(j))) for j in jit]
    torch.testing.assert_close(prog, (frames[0] + frames[1]) / 2, rtol=1e-6, atol=1e-7)
    assert not torch.equal(frames[0], frames[1])


def test_budget_overflow_paints_red_on_the_unfused_route(sphere):
    _, _, tp, renderers = sphere
    packed = renderers["binary"].packed
    linear = RenderStatics(width=32, height=32, do_tonemap=False)
    img = engine_frame.render_frame(packed, tp, linear, Config(packet_max_steps=1))
    red = torch.tensor([1.0, 0.0, 0.0])
    painted = (img == red).all(dim=-1)
    assert painted.all()  # one step never finishes a walk of more than one node
    ok = engine_frame.render_frame(packed, tp, linear, Config())
    assert not (ok == red).all(dim=-1).any()


def test_frame_plain_probe_reports_walks_and_env_directions(sphere):
    """The probe hands out what a bound of the frame counts: one
    ``WalkResult`` per walk phase whose sums are the counter row (exact),
    and the directions of the env lookup (rays that missed keep their
    unit primary direction); the frame is unchanged."""
    from shader_ray_tpu_torch.ops import frame_kernel as fk

    _, _, tp, renderers = sphere
    packed = renderers["fused"].packed
    uni = engine_frame.pack_uniforms(tp)
    jit = torch.zeros((1, 2))
    fs = fk.FrameSettings(width=32, height=32)
    probe = {}
    col, counters = fk.frame_plain(packed, uni, jit, fs, probe)
    plain, _ = fk.frame_plain(packed, uni, jit, fs)
    assert torch.equal(col, plain)
    assert len(probe["walks"]) == fs.phases() == 6
    for p, w in enumerate(probe["walks"]):
        assert int(w.steps.sum()) == int(counters[1 + 3 * p])
        assert int(w.tris.sum()) == int(counters[3 + 3 * p])
        assert 0 < int(w.slabs.sum()) <= 8 * int(w.steps.sum())
    assert probe["env_D"].shape == (32 * 32, 3)
    assert torch.isfinite(probe["env_D"]).all()
    missed = probe["walks"][0].t >= fk.INFINITELY_FAR
    assert missed.any() and not missed.all()
    torch.testing.assert_close(probe["env_D"][missed].norm(dim=1),
                               torch.ones(int(missed.sum())), rtol=1e-5, atol=1e-5)
