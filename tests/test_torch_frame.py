"""The slice as a whole on ``Renderer(device="cpu")`` (the frame
kernel's plain PyTorch version): frames against the reference's
wavefront engine and the committed sphere golden, progressive against
its own frames, and the cast-ray count against the reference's.

Frame tolerance: mean abs < 2e-3 and >= 99% of pixels within 2e-2 (on
the 0-1 tonemapped scale).  No exact match is expected: the port tests
leaves with the Woop affine and the reference with Moller-Trumbore, so
t, barycentrics and equal-distance tie order round differently, and a
grazing ray can flip between hit and miss."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models.fixtures import bunny_class_scene, procedural_sky, uv_sphere
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.models.world import get_shader_data, make_world
from shader_ray_tpu.ops.render import RenderStatics as RefStatics
from shader_ray_tpu.ops.render import default_frame_params as ref_default_params
from shader_ray_tpu.ops.render import generate_rays as ref_generate_rays
from shader_ray_tpu.ops.render import render_frame as ref_render_frame
from shader_ray_tpu.ops.render import trace_rays as ref_trace_rays
from shader_ray_tpu.ops.scene import upload_scene
from shader_ray_tpu.utils import mat4 as ref_mat4
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.convert import frame_params_from_numpy, scene_data_from_numpy
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.ops.engine_frame import halton_jitters
from shader_ray_tpu_torch.ops.render import RenderStatics
from shader_ray_tpu_torch.ops.shading import filmic
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sphere_gold_64.npy")
N = 64


def assert_frame_close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.mean() < 2e-3, err.mean()
    assert (err.max(axis=-1) <= 2e-2).mean() >= 0.99, (err.max(axis=-1) > 2e-2).mean()


@pytest.fixture(scope="module")
def bench_like():
    """A bench-style scene at test size: perturbed sphere, diffuse red
    with shadows, 5% specular, a rotated object, a tilted light."""
    pos, nrm = bunny_class_scene(1500)
    cfg = RefConfig()
    cfg.use_native = "never"
    ref = get_shader_data(make_world(RefTriangleSet.from_arrays(pos, nrm), cfg), cfg)
    env = procedural_sky(256)
    fov = np.deg2rad(40.0)
    rot = ref_mat4.make_rotation(0.5, 0.0, 1.0, 0.0)
    inv = ref_mat4.invert(rot)
    jp = ref_default_params(fov=fov)._replace(
        camera_matrix=jnp.asarray(ref_mat4.make_translation(0.0, 0.0, 2.6 / 2.0 / np.sin(fov / 2.0))),
        object_matrix=jnp.asarray(inv),
        object_normal_matrix=jnp.asarray(inv),
        object_normal_inverse=jnp.asarray(rot),
        light_dir=jnp.asarray(np.array([0.36, 0.48, 0.8], np.float32)),
        diffuse_color=jnp.asarray(np.array([0.8, 0.2, 0.2], np.float32)),
        specular_color=jnp.asarray(np.array([0.05, 0.05, 0.05], np.float32)),
    )
    tp = frame_params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()})
    data = scene_data_from_numpy(vars(ref))
    renderer = Renderer(data, env, device="cpu")
    return upload_scene(ref, env), jp, renderer, tp, data, env


@pytest.fixture(scope="module")
def wavefront(bench_like):
    """The reference wavefront engine's N x N frame (``render_frame``
    under one ``jax.jit``: eager, it dispatches its while-loops op by op
    for ~20 s) and its cast-ray count (``trace_rays(with_counts=True)``,
    jitted as well)."""
    scene, jp, _, _, _, _ = bench_like
    statics = RefStatics(width=N, height=N, tile_size=N * N)
    frame = jax.jit(lambda s, p: ref_render_frame(s, p, statics))(scene, jp)
    rays = ref_generate_rays(statics, jp)[0]
    _, cast = jax.jit(lambda s, p: ref_trace_rays(s, rays, p, statics, with_counts=True))(scene, jp)
    return np.asarray(frame), int(cast)


def test_frame_matches_wavefront_engine(bench_like, wavefront):
    _, _, renderer, tp, _, _ = bench_like
    want = wavefront[0]
    got = renderer.make_fn(RenderStatics(width=N, height=N))(tp).numpy()
    assert got.shape == (N, N, 3) and np.isfinite(got).all()
    assert_frame_close(got, want)
    checksum = renderer.make_checksum_fn(RenderStatics(width=N, height=N))(tp)
    assert float(checksum) == pytest.approx(float(got.sum()), rel=1e-6)


def test_cast_count_matches_reference(bench_like, wavefront):
    _, _, renderer, tp, _, _ = bench_like
    cast = wavefront[1]
    got = renderer.make_count_fn(RenderStatics(width=N, height=N))(tp)
    assert N * N <= got <= 6 * N * N
    assert abs(got - cast) <= 0.005 * cast, (got, cast)


def test_frame_matches_sphere_golden():
    pos, _ = uv_sphere(lat=12, lon=16)
    cfg = RefConfig()
    cfg.use_native = "never"
    ref = get_shader_data(make_world(RefTriangleSet.from_arrays(pos), cfg), cfg)
    renderer = Renderer(scene_data_from_numpy(vars(ref)), procedural_sky(256), device="cpu")
    params = ref_default_params()._replace(
        camera_matrix=jnp.asarray(ref_mat4.make_translation(0, 0, 3.2)),
        specular_color=jnp.asarray(np.array([1.0, 0.71, 0.29], np.float32)),
        diffuse_color=jnp.zeros(3, jnp.float32),
    )
    tp = frame_params_from_numpy({k: np.asarray(v) for k, v in params._asdict().items()})
    got = renderer.make_fn(RenderStatics(width=N, height=N))(tp).numpy()
    assert_frame_close(got, np.load(GOLDEN))


def test_progressive_is_mean_of_jittered_frames(bench_like):
    _, _, renderer, tp, _, _ = bench_like
    linear = RenderStatics(width=32, height=32, do_tonemap=False)
    prog = renderer.make_progressive_fn(linear, 4)(tp)
    frame = renderer.make_fn(linear)
    jit = halton_jitters(4)
    frames = [frame(tp._replace(pixel_jitter=torch.from_numpy(j))) for j in jit]
    mean = (frames[0] + frames[1] + frames[2] + frames[3]) / 4
    # same per-sample arithmetic, same summation order: equal to f32 rounding
    torch.testing.assert_close(prog, mean, rtol=1e-6, atol=1e-7)
    assert not torch.equal(frames[0], frames[1])  # the jitter moved the samples
    toned = renderer.make_progressive_fn(linear._replace(do_tonemap=True), 4)(tp)
    torch.testing.assert_close(toned, filmic(mean), rtol=1e-6, atol=1e-7)
    assert float(renderer.make_progressive_fn(linear, 4, reduce_sum=True)(tp)) == \
        pytest.approx(float(prog.sum()), rel=1e-6)


def test_walk_budget_overflow_paints_red(bench_like):
    _, _, _, tp, data, env = bench_like
    # one node pop per walk: every ray that must descend is bad
    tight = Renderer(data, env, Config(packet_max_steps=1), device="cpu")
    img = tight.make_fn(RenderStatics(width=32, height=32))(tp).numpy()
    red = filmic(torch.tensor([1.0, 0.0, 0.0])).numpy()
    painted = np.all(np.abs(img - red) < 1e-6, axis=-1)
    assert 0.05 < painted.mean() < 0.95  # object pixels red, sky pixels not
