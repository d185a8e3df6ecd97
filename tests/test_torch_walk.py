"""The port's plain 8-wide walk (closest and any hit) against the
reference's wavefront traversal (ops/traversal.traverse) and the
brute-force numpy oracle (ops/reference.intersect_brute), on seeded
rays that include exactly axis-aligned directions and the default light
(0, 0, 1) — the directions whose zero components the safe reciprocal
exists for.

Tolerances: t agrees at rtol 1e-5 (Woop vs Moller-Trumbore arithmetic
differ by a few ulp of f32); hit ids are equal except at exact ties,
where two triangles share the hit distance (|dt| < 1e-6, e.g. a ray
through a shared edge); hit/occlusion flags are equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models.fixtures import bunny_class_scene, procedural_sky, uv_sphere
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.models.world import get_shader_data, make_world
from shader_ray_tpu.ops.reference import intersect_brute
from shader_ray_tpu.ops.scene import upload_scene
from shader_ray_tpu.ops.traversal import traverse
from shader_ray_tpu_torch.convert import scene_data_from_numpy
from shader_ray_tpu_torch.ops.frame_kernel import INFINITELY_FAR, walk_plain
from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide

SCENES = {
    "bunny1k": lambda: bunny_class_scene(1000),
    "uv_sphere": lambda: uv_sphere(lat=10, lon=14),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    pos, nrm = SCENES[request.param]()
    cfg = RefConfig()
    cfg.use_native = "never"
    ref = get_shader_data(make_world(RefTriangleSet.from_arrays(pos, nrm), cfg), cfg)
    env = procedural_sky(32)
    packed = pack_scene_wide(scene_data_from_numpy(vars(ref)), env)
    return ref, upload_scene(ref, env), packed


def _rays(seed: int):
    rng = np.random.default_rng(seed)
    n = 400
    P = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    D = rng.normal(size=(n, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    axes = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                    np.float32)
    D[: 6 * 20] = np.repeat(axes, 20, axis=0)  # exact zeros in two components
    D[6 * 20 : 6 * 20 + 40] = [0.0, 0.0, 1.0]   # the default light direction
    return P, D


def _walk(packed, P, D, any_hit, **kw):
    act = torch.ones(P.shape[0], dtype=torch.bool)
    return walk_plain(packed, torch.from_numpy(P), torch.from_numpy(D), act, any_hit, **kw)


def _check_hits(t, which, t_ref, which_ref):
    hit = t < INFINITELY_FAR
    hit_ref = t_ref < INFINITELY_FAR
    np.testing.assert_array_equal(hit, hit_ref)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5)
    differ = hit & (which != which_ref)
    assert (np.abs(t[differ] - t_ref[differ]) < 1e-6).all(), "id mismatch that is not a tie"
    assert differ.mean() < 0.02
    return hit


def test_closest_hit_matches_brute_and_traverse(scene):
    ref, dscene, packed = scene
    P, D = _rays(11)
    w = _walk(packed, P, D, any_hit=False)
    assert not w.bad.any()
    t, which = w.t.numpy(), w.which.numpy()
    tb, wb, _, _ = intersect_brute(ref.tri_positions.reshape(-1, 3, 3), P, D)
    hit = _check_hits(t, which, tb, wb)
    assert hit.mean() > 0.1
    tr = traverse(dscene, jnp.asarray(P), jnp.asarray(D))
    _check_hits(t, which, np.asarray(tr.t), np.asarray(tr.which))
    # the interpolated normal of the hit triangle (n0 + u*d1 + v*d2)
    n = w.normal.numpy()[hit]
    assert np.isfinite(n).all() and (np.linalg.norm(n, axis=1) > 0.5).all()


def test_any_hit_occlusion_flags(scene):
    ref, _, packed = scene
    P, D = _rays(12)
    w = _walk(packed, P, D, any_hit=True)
    assert not w.bad.any()
    tb, _, _, _ = intersect_brute(ref.tri_positions.reshape(-1, 3, 3), P, D)
    occluded = w.t.numpy() < INFINITELY_FAR
    np.testing.assert_array_equal(occluded, tb < INFINITELY_FAR)
    assert (w.t.numpy()[occluded] == 0.0).all()
    # axis-aligned light rays from below the geometry must be shadowed:
    # an IEEE-inf reciprocal would have NaN-killed these walks
    light = slice(6 * 20, 6 * 20 + 40)
    assert occluded[light].any() or not (tb[light] < INFINITELY_FAR).any()
    # any-hit stops early: never more work than the closest-hit walk
    wc = _walk(packed, P, D, any_hit=False)
    assert (w.steps <= wc.steps).all() and (w.tris <= wc.tris).all()


def test_budget_and_stack_overflow_mark_rays_bad(scene):
    _, _, packed = scene
    P, D = _rays(13)
    full = _walk(packed, P, D, any_hit=False)
    one = _walk(packed, P, D, any_hit=False, max_steps=1)
    assert one.bad.any() and (one.steps <= 1).all()
    assert (full.steps[one.bad] > 1).all()
    ok = ~one.bad
    np.testing.assert_array_equal(one.t[ok].numpy(), full.t[ok].numpy())
    shallow = dataclasses.replace(packed, stack_depth=2)
    low = _walk(shallow, P, D, any_hit=False)
    assert low.bad.any()
    ok = ~low.bad
    np.testing.assert_array_equal(low.t[ok].numpy(), full.t[ok].numpy())
