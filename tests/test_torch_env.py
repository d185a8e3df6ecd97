"""The port's env lookup against the reference: ``env_coords`` and the
level-0 bilinear REPEAT fetch against shader_ray_tpu/ops/envmap.env_coords
and sample_environment(which=0), on seeded directions plus the poles,
the u seam (z = +-0 behind the viewer) and axis-aligned directions;
and the env pack's resample against the reference packer's.

Tolerance 1e-5: u, v are f32 and atan2/acos of the two libraries may
differ by an ulp; the fetch interpolates an HDR sky whose values reach
~50 near the sun, so colours are compared relative to 1e-5 of their
magnitude (plus 1e-5 absolute)."""

import jax.numpy as jnp
import numpy as np
import torch

from shader_ray_tpu.ops import envmap as ref_envmap
from shader_ray_tpu.ops.pallas.pack import _resize_env as ref_resize_env
from shader_ray_tpu.ops.scene import upload_scene
from shader_ray_tpu.models.world import SceneData as RefSceneData
from shader_ray_tpu_torch.models.fixtures import procedural_sky
from shader_ray_tpu_torch.ops import envmap
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _directions(rng):
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    special = np.array([
        [0, 1, 0], [0, -1, 0],                       # poles
        [-1, 0, 0], [-1, 0, -0.0], [-1, 0, 1e-7], [-1, 0, -1e-7],  # u seam
        [1, 0, 0], [0, 0, 1], [0, 0, -1],            # axes
        [0.6, 0.8, 0], [0.3, -1.0000001, 0.1],       # |y| slightly past 1
    ], np.float32)
    return np.concatenate([d, special])


def test_env_coords(rng):
    d = _directions(rng)
    u, v = envmap.env_coords(torch.from_numpy(d))
    ru, rv = ref_envmap.env_coords(jnp.asarray(d))
    np.testing.assert_allclose(u.numpy(), np.asarray(ru), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=0, atol=1e-5)
    assert ((u >= 0.5) & (u <= 1.5)).all() and ((v >= 0) & (v <= 1)).all()


def test_level0_bilinear_matches_sample_environment(rng):
    sky = procedural_sky(128)  # 64 x 128: a power of two, so no resample
    env = envmap.pack_env(sky, 1024)
    assert env.shape == sky.shape and env.tobytes() == sky.tobytes()
    tri = np.zeros((1, 9), np.float32)
    dummy = RefSceneData(
        tri_positions=tri, tri_normals=tri, tri_colors=tri,
        node_boxes=np.zeros((1, 8), np.float32), node_objects=np.zeros((1, 2), np.int32),
        hitmiss=np.full((8, 1, 2), -1, np.int32), tree_root=0, triangle_count=0, group_count=1,
    )
    scene = upload_scene(dummy, sky)
    d = _directions(rng)
    zeros = jnp.zeros_like(jnp.asarray(d))
    want = np.asarray(ref_envmap.sample_environment(scene, jnp.asarray(d), zeros, zeros, which=0))
    got = envmap.sample_env(torch.from_numpy(env), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_env_pack_resample():
    # non-power-of-two source -> resampled to the pow2 at/above its height
    sky = procedural_sky(200)  # 100 x 200
    env = envmap.pack_env(sky, 1024)
    assert env.shape == (128, 256, 3)
    np.testing.assert_array_equal(env, ref_resize_env(sky, 128, 256))
    # the base cap wins over the source height (integer-factor average)
    env = envmap.pack_env(procedural_sky(512), 64)
    assert env.shape == (64, 128, 3)
    np.testing.assert_array_equal(env, ref_resize_env(procedural_sky(512), 64, 128))
