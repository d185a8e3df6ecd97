"""Frame math of the port (vecmath, shading, pinhole rays, the uniform
table) against the reference package's JAX functions on the same
seeded inputs.  Tolerance 1e-6 absolute: both sides are f32 with the
same formulas; only op order inside a fused XLA expression may round
differently by an ulp or two of values of order 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shader_ray_tpu.ops import shading as ref_shading
from shader_ray_tpu.ops import vecmath as ref_vecmath
from shader_ray_tpu.ops.engine_pallas import _pack_uniforms as ref_pack_uniforms
from shader_ray_tpu.ops.render import RenderStatics as RefStatics
from shader_ray_tpu.ops.render import default_frame_params as ref_default_params
from shader_ray_tpu.ops.render import generate_rays as ref_generate_rays
from shader_ray_tpu.ops.render import rays_for_pixels as ref_rays_for_pixels
from shader_ray_tpu.utils import mat4 as ref_mat4
from shader_ray_tpu_torch.convert import frame_params_from_numpy
from shader_ray_tpu_torch.ops import shading, vecmath
from shader_ray_tpu_torch.ops.engine_frame import pack_uniforms
from shader_ray_tpu_torch.ops.render import RenderStatics, default_frame_params, generate_rays, rays_for_pixels
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-6


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def _vecs(rng, n=257):
    return rng.normal(size=(n, 3)).astype(np.float32)


def test_vecmath(rng):
    a, b = _vecs(rng), _vecs(rng)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    ta, tb, tm = (torch.from_numpy(x) for x in (a, b, m))
    ja, jb, jm = (jnp.asarray(x) for x in (a, b, m))
    close(vecmath.dot(ta, tb), ref_vecmath.dot(ja, jb), 4 * TOL)
    close(vecmath.cross(ta, tb), ref_vecmath.cross(ja, jb), 4 * TOL)
    close(vecmath.normalize(ta), ref_vecmath.normalize(ja))
    n = vecmath.normalize(tb)
    close(vecmath.reflect(ta, n), ref_vecmath.reflect(ja, jnp.asarray(n.numpy())), 4 * TOL)
    close(vecmath.transform_point(tm, ta), ref_vecmath.transform_point(jm, ja), 8 * TOL)
    close(vecmath.transform_dir(tm, ta), ref_vecmath.transform_dir(jm, ja), 8 * TOL)


def test_shading(rng):
    fields = [_vecs(rng) * 0.1 for _ in range(6)]
    fields[1] = fields[1] / np.linalg.norm(fields[1], axis=1, keepdims=True)
    nrm = _vecs(rng)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    t = rng.uniform(0.5, 3.0, 257).astype(np.float32)
    tr = shading.Rays(*[torch.from_numpy(x) for x in fields])
    jr = ref_shading.Rays(*[jnp.asarray(x) for x in fields])
    tn, jn = torch.from_numpy(nrm), jnp.asarray(nrm)
    got = shading.ray_transfer(tr, torch.from_numpy(t), tn)
    want = ref_shading.ray_transfer(jr, jnp.asarray(t), jn)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=TOL)
    got = shading.ray_reflect(tr, tn, 1e-4)
    want = ref_shading.ray_reflect(jr, jn, 1e-4)
    for g, w in zip(got, want):
        close(g, w, 4 * TOL)
    spec = np.array([0.05, 0.71, 1.0], np.float32)
    close(shading.f_schlick_vr(torch.from_numpy(spec), tr.D, tn),
          ref_shading.f_schlick_vr(jnp.asarray(spec), jr.D, jn))
    c = rng.uniform(0.0, 8.0, (257, 3)).astype(np.float32)
    for filmic in (True, False):
        close(shading.tonemap_and_gamma(torch.from_numpy(c), filmic),
              ref_shading.tonemap_and_gamma(jnp.asarray(c), filmic))
    close(shading.filmic(torch.from_numpy(c)), ref_shading.filmic(jnp.asarray(c)))


def _params(rng):
    """A non-trivial camera/object pose and material, seeded."""
    fov = np.deg2rad(35.0)
    cam = ref_mat4.mult(ref_mat4.make_rotation(0.3, 0.0, 1.0, 0.0),
                        ref_mat4.make_translation(0.2, -0.1, 3.0))
    rot = ref_mat4.make_rotation(0.7, 0.6, 0.8, 0.0)
    jp = ref_default_params(fov=fov)._replace(
        camera_matrix=jnp.asarray(cam),
        camera_normal_matrix=jnp.asarray(cam),
        object_matrix=jnp.asarray(ref_mat4.invert(rot)),
        object_normal_matrix=jnp.asarray(ref_mat4.invert(rot)),
        object_normal_inverse=jnp.asarray(rot),
        light_dir=jnp.asarray(np.array([0.3, 0.8, 0.52], np.float32)),
        diffuse_color=jnp.asarray(rng.uniform(0, 1, 3).astype(np.float32)),
        specular_color=jnp.asarray(rng.uniform(0, 1, 3).astype(np.float32)),
        pixel_jitter=jnp.asarray(np.array([0.31, -0.27], np.float32)),
    )
    tp = frame_params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()})
    return jp, tp


def test_rays_for_pixels_with_jitter(rng):
    jp, tp = _params(rng)
    W, H = 24, 16
    ref_rays, (rr, ru) = ref_rays_for_pixels(
        RefStatics(width=W, height=H), jp,
        jnp.arange(H, dtype=jnp.float32)[:, None], jnp.arange(W, dtype=jnp.float32)[None, :],
    )
    rays, (r, u) = rays_for_pixels(
        RenderStatics(width=W, height=H), tp,
        torch.arange(H, dtype=torch.float32)[:, None], torch.arange(W, dtype=torch.float32)[None, :],
    )
    for g, w in zip(rays, ref_rays):
        close(g, w)
    close(r, rr)
    close(u, ru)
    gen = generate_rays(RenderStatics(width=W, height=H), tp._replace(pixel_jitter=None))
    ref_gen, _ = ref_generate_rays(RefStatics(width=W, height=H), jp._replace(pixel_jitter=None))
    for g, w in zip(gen, ref_gen):
        close(g, w)


def test_pack_uniforms_and_default_params(rng):
    jp, tp = _params(rng)
    close(pack_uniforms(tp), ref_pack_uniforms(jp), 0.0)
    ref = ref_default_params(fov=np.deg2rad(50.0))
    port = default_frame_params(fov=np.deg2rad(50.0))
    for name in ref._fields:
        close(getattr(port, name), getattr(ref, name), 0.0)


def test_default_statics_match():
    ref = RefStatics()
    port = RenderStatics()
    for name in port._fields:
        assert getattr(port, name) == getattr(ref, name), name
    with pytest.raises(NotImplementedError):
        from shader_ray_tpu_torch.ops.engine_frame import frame_settings

        frame_settings(port._replace(which=1))
