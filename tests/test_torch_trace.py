"""The port's trace-only functions on the CPU (their plain versions)
against the reference: ``trace_wide`` against the Pallas wide kernel
``packet_trace_wide`` (interpret mode, one 1024-ray tile, as
tests/test_packet_wide.py runs it) and the brute-force oracle;
``trace_binary`` against the per-lane wavefront traversal
(ops/traversal.traverse) and the oracle; the ``PacketHit`` contract for
inactive and over-budget rays; and the hit/miss link banks against the
reference's ``create_hitmiss``.  Rays are seeded and include exactly
axis-aligned directions and the default light (0, 0, 1).

Tolerances: t agrees at rtol 1e-5 plus 1e-6 absolute (Woop,
Moller-Trumbore and the two libraries round differently by a few ulp of
f32, and a hit close to the origin inherits the absolute rounding of
coordinates of magnitude ~1); hit ids are equal
except at exact ties, where two triangles share the hit distance
(|dt| < 1e-6, a ray through a shared edge or vertex) and visit order
decides; hit and occlusion flags are equal."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models.fixtures import bunny_class_scene, procedural_sky, uv_sphere
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.models.world import get_shader_data as ref_get_shader_data
from shader_ray_tpu.models.world import make_world as ref_make_world
from shader_ray_tpu.ops.pallas.pack_wide import pack_scene_wide as ref_pack_scene_wide
from shader_ray_tpu.ops.pallas.packet_wide import packet_trace_wide
from shader_ray_tpu.ops.reference import intersect_brute
from shader_ray_tpu.ops.scene import upload_scene
from shader_ray_tpu.ops.traversal import traverse
from shader_ray_tpu_torch.convert import packed_from_numpy
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.ops.trace_kernel import INFINITELY_FAR, trace, trace_binary, trace_wide
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCENES = {
    "bunny1k": lambda: bunny_class_scene(1000),
    "uv_sphere": lambda: uv_sphere(lat=10, lon=14),
}
N_RAYS = 1024


def _ref_data(name):
    pos, nrm = SCENES[name]()
    cfg = RefConfig()
    cfg.use_native = "never"
    return pos, nrm, ref_get_shader_data(ref_make_world(RefTriangleSet.from_arrays(pos, nrm), cfg), cfg)


@functools.cache
def _scene(name):
    _, _, ref = _ref_data(name)
    env = procedural_sky(32)
    return dict(
        ref=ref,
        device_scene=upload_scene(ref, env),
        ref_wide=ref_pack_scene_wide(ref, env),
        wide=packed_from_numpy(vars(ref), env, "wide"),
        binary=packed_from_numpy(vars(ref), env, "binary"),
    )


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    return _scene(request.param)


def _rays(seed: int):
    rng = np.random.default_rng(seed)
    P = rng.uniform(-1.6, 1.6, (N_RAYS, 3)).astype(np.float32)
    D = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    axes = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                    np.float32)
    D[: 6 * 20] = np.repeat(axes, 20, axis=0)  # exact zeros in two components
    D[6 * 20 : 6 * 20 + 40] = [0.0, 0.0, 1.0]   # the default light direction
    active = rng.uniform(size=N_RAYS) < 0.7
    return P, D, active


def _check_hits(t, which, t_ref, which_ref):
    hit = t < INFINITELY_FAR
    np.testing.assert_array_equal(hit, t_ref < INFINITELY_FAR)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5, atol=1e-6)
    differ = hit & (which != which_ref)
    assert (np.abs(t[differ] - t_ref[differ]) < 1e-6).all(), "id mismatch that is not a tie"
    assert differ.mean() < 0.02
    return hit


@pytest.mark.parametrize("kernel", ["wide", "binary"])
def test_closest_hit_matches_brute(scene, kernel):
    P, D, _ = _rays(21)
    got = trace(scene[kernel], torch.from_numpy(P), torch.from_numpy(D))
    assert not got.bad.any() and got.stats is None
    assert got.which.dtype == torch.int32 and got.t.dtype == torch.float32
    tb, wb, _, _ = intersect_brute(scene["ref"].tri_positions.reshape(-1, 3, 3), P, D)
    hit = _check_hits(got.t.numpy(), got.which.numpy(), tb, wb)
    assert hit.mean() > 0.1
    assert (got.which.numpy()[~hit] == -1).all()
    n = got.normal.numpy()
    assert np.isfinite(n).all() and (np.linalg.norm(n[hit], axis=1) > 0.5).all()


def test_wide_matches_pallas_wide_kernel():
    # one scene each for this and the any-hit comparison (every call
    # compiles the interpreted kernel anew); smooth normals here
    scene = _scene("uv_sphere")
    P, D, active = _rays(22)
    ref = packet_trace_wide(
        scene["ref_wide"], jnp.asarray(P), jnp.asarray(D), active=jnp.asarray(active),
        tile=1024, interpret=True,
    )
    got = trace_wide(scene["wide"], torch.from_numpy(P), torch.from_numpy(D),
                     torch.from_numpy(active))
    hit = _check_hits(got.t.numpy(), got.which.numpy(), np.asarray(ref.t), np.asarray(ref.which))
    assert not hit[~active].any()
    # interpolated normals: the same n0 + u*d1 + v*d2, to f32 rounding of u, v
    same = hit & (got.which.numpy() == np.asarray(ref.which))
    np.testing.assert_allclose(got.normal.numpy()[same], np.asarray(ref.normal)[same],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.bad.numpy(), np.asarray(ref.bad))


def test_wide_any_hit_matches_pallas_wide_kernel():
    scene = _scene("bunny1k")
    P, D, active = _rays(23)
    ref = packet_trace_wide(
        scene["ref_wide"], jnp.asarray(P), jnp.asarray(D), active=jnp.asarray(active),
        tile=1024, any_hit=True, interpret=True,
    )
    got = trace_wide(scene["wide"], torch.from_numpy(P), torch.from_numpy(D),
                     torch.from_numpy(active), any_hit=True)
    occluded = got.t.numpy() < INFINITELY_FAR
    np.testing.assert_array_equal(occluded, np.asarray(ref.t) < INFINITELY_FAR)
    assert (got.t.numpy()[occluded] == 0.0).all() and not occluded[~active].any()


def test_binary_matches_wavefront_traversal(scene):
    P, D, active = _rays(24)
    ref = traverse(scene["device_scene"], jnp.asarray(P), jnp.asarray(D),
                   max_bvh_iterations=100000, active=jnp.asarray(active))
    got = trace_binary(scene["binary"], torch.from_numpy(P), torch.from_numpy(D),
                       torch.from_numpy(active))
    t, which = got.t.numpy(), got.which.numpy()
    # the same walk, the same Moller-Trumbore arithmetic and accept
    # order: ids are equal wherever both found a hit
    hit = _check_hits(t, which, np.asarray(ref.t), np.asarray(ref.which))
    np.testing.assert_array_equal(which[hit], np.asarray(ref.which)[hit])
    assert not got.bad.any() and not hit[~active].any()
    # normal = n0 + u (n1 - n0) + v (n2 - n0) with the traversal's (u, v)
    tri_n = scene["ref"].tri_normals[np.maximum(which, 0)]
    u, v = np.asarray(ref.u)[:, None], np.asarray(ref.v)[:, None]
    want = tri_n[:, 0:3] * (1 - u - v) + tri_n[:, 3:6] * u + tri_n[:, 6:9] * v
    np.testing.assert_allclose(got.normal.numpy()[hit], want[hit], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel", ["wide", "binary"])
def test_any_hit_and_active_mask(scene, kernel):
    P, D, active = _rays(25)
    args = (scene[kernel], torch.from_numpy(P), torch.from_numpy(D), torch.from_numpy(active))
    occ = trace(*args, any_hit=True, with_stats=True)
    full = trace(*args, with_stats=True)
    tb, _, _, _ = intersect_brute(scene["ref"].tri_positions.reshape(-1, 3, 3), P, D)
    occluded = occ.t.numpy() < INFINITELY_FAR
    np.testing.assert_array_equal(occluded, (tb < INFINITELY_FAR) & active)
    assert (occ.t.numpy()[occluded] == 0.0).all()
    assert (occ.which.numpy() == -1).all()  # an occlusion query records no id
    # inactive rays: a miss, no id, no work
    idle = ~active
    assert (full.t.numpy()[idle] == np.float32(INFINITELY_FAR)).all()
    assert (full.which.numpy()[idle] == -1).all() and (full.stats.numpy()[idle] == 0).all()
    # axis-aligned light rays that the oracle finds occluded are occluded:
    # an IEEE-inf reciprocal would have NaN-killed these walks
    light = np.zeros(N_RAYS, bool)
    light[6 * 20 : 6 * 20 + 40] = True
    assert (occluded[light & active] == (tb < INFINITELY_FAR)[light & active]).all()
    # any-hit stops early: never more work than the closest-hit walk
    assert (occ.stats <= full.stats).all() and (occ.stats.sum(0) < full.stats.sum(0)).all()


@pytest.mark.parametrize("kernel", ["wide", "binary"])
def test_one_step_budget_marks_rays_bad(scene, kernel):
    P, D, _ = _rays(26)
    args = (scene[kernel], torch.from_numpy(P), torch.from_numpy(D))
    full = trace(*args, with_stats=True)
    one = trace(*args, max_steps=1, with_stats=True)
    assert one.bad.any() and (one.stats[:, 0] <= 1).all()
    assert (full.stats[:, 0][one.bad] > 1).all()
    # the PacketHit contract of a bad ray (kernel_wide.py:849-850)
    assert (one.t[one.bad] == -1.0).all() and (one.which[one.bad] == -1).all()
    ok = ~one.bad
    np.testing.assert_array_equal(one.t[ok].numpy(), full.t[ok].numpy())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_hitmiss_banks_equal_reference(name):
    pos, nrm, ref = _ref_data(name)
    data = get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm)))
    assert data.hitmiss.shape == (8, data.group_count, 2) and data.hitmiss.dtype == np.int32
    assert data.hitmiss.tobytes() == ref.hitmiss.tobytes()
    packed = packed_from_numpy(vars(ref), procedural_sky(32), "binary")
    # (N, 8, 2): node-major, so one ray's next node is one 8-byte read
    np.testing.assert_array_equal(packed.links.numpy(), ref.hitmiss.transpose(1, 0, 2))
    leaf = packed.leaf.numpy()
    np.testing.assert_array_equal(leaf[:, 0], ref.node_objects[:, 0])
    assert leaf[:, 1].max() <= 10 and ((leaf[:, 1] > 0) == (ref.node_objects[:, 1] > 0)).all()
    assert packed.root == ref.tree_root and packed.tris.shape == (ref.triangle_count, 18)


def test_trace_rejects_mixed_devices(scene):
    P, D, _ = _rays(27)
    with pytest.raises(ValueError, match="device"):
        trace_wide(scene["wide"], torch.from_numpy(P).to("meta"), torch.from_numpy(D))
    with pytest.raises(ValueError, match="contiguous"):
        trace_binary(scene["binary"], torch.from_numpy(P).double(), torch.from_numpy(D))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kernel", ["wide", "binary"])
def test_plain_walks_count_the_work_of_a_sequential_walk(scene, kernel, any_hit):
    """The counts an operation bound charges: a binary step is one slab
    test, a wide pop tests at most 8 (only its non-empty children), and
    a triangle test reaches u only past its distance test and v only
    past u.  Exact integer relations, no tolerance."""
    from shader_ray_tpu_torch.ops.trace_kernel import walk_binary_plain, walk_plain

    P, D, active = (torch.from_numpy(x) for x in _rays(25))
    plain = walk_plain if kernel == "wide" else walk_binary_plain
    w = plain(scene[kernel], P, D, active, any_hit)
    assert (w.tris_v <= w.tris_u).all() and (w.tris_u <= w.tris).all()
    assert (w.slabs[~active] == 0).all() and (w.tris[~active] == 0).all()
    hit = (w.t < INFINITELY_FAR) & ~w.bad
    assert hit.any() and (w.tris_v[hit] >= 1).all()   # an accepted hit went all the way
    assert w.tris_v.sum() < w.tris_u.sum() < w.tris.sum()  # some tests end at each stage
    if kernel == "binary":
        assert torch.equal(w.slabs, w.steps)
    else:
        assert (w.slabs <= 8 * w.steps).all() and (w.slabs[active] >= 1).all()
        assert w.slabs.sum() < 8 * w.steps.sum()      # empty child slots are not charged
