"""The port's grad-mode env lookup on the CPU against the reference:
``env_derivatives`` and ``aniso_lod_and_probes`` against
shader_ray_tpu/ops/envmap; the packed pyramid against the levels of
``pack_env_planes``; and ``env_sample`` (its plain version) in mode 0
and grad mode with ``aniso`` 1 and 4 against the per-ray oracle
``sample_environment`` (``which`` 0 / 1), on seeded directions that
cross the u seam and come close to both poles.

The port's pyramid stops at height 16 as the plane pyramid does, the
oracle's atlas goes down to 1 x 1, so lod clips at different levels:
the two are held equal only for rays whose lod lies at or below the
port's last level (rho <= 2^(NL-1)); beyond it the port must equal its
own last level.

Tolerance: rtol 2e-4 / atol 2e-4 on radiance.  u, v and the lod go
through atan2, acos and log2 of two libraries (an ulp apart), the
bilinear weights amplify an ulp of u by the level width, and the sky's
sun reaches ~50."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shader_ray_tpu.models.world import SceneData as RefSceneData
from shader_ray_tpu.ops import envmap as ref_envmap
from shader_ray_tpu.ops.pallas.envwin import pack_env_planes
from shader_ray_tpu.ops.scene import upload_scene
from shader_ray_tpu_torch.models.fixtures import procedural_sky
from shader_ray_tpu_torch.ops import envmap
from shader_ray_tpu_torch.ops.env_kernel import env_sample
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SKY_W = 256  # 128 x 256: levels 128, 64, 32, 16


def _rays(seed: int, n: int = 3000):
    """Directions + differentials whose footprints span lod < 0 to lod
    past the last level."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(n, 3)).astype(np.float32)
    special = np.array([
        [-1, 0, 1e-7], [-1, 0, -1e-7], [-1, 0, 1e-3], [-1, 0, -1e-3],   # u seam
        [0.02, 0.9998, 0.0], [0.0, -0.9998, 0.02], [1e-3, 1.0, 1e-3],   # near the poles
        [1, 0, 0], [0, 0, 1], [0, 0, -1],                               # axes
    ], np.float32)
    D[: len(special)] = special
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    scale = (10.0 ** rng.uniform(-4.0, -0.5, size=(n, 1))).astype(np.float32)
    gx = rng.normal(size=(n, 3)).astype(np.float32) * scale
    gy = rng.normal(size=(n, 3)).astype(np.float32) * scale * \
        (10.0 ** rng.uniform(-1.0, 0.0, size=(n, 1))).astype(np.float32)   # anisotropic
    return D, gx, gy


@pytest.fixture(scope="module")
def sky():
    return procedural_sky(SKY_W)


@pytest.fixture(scope="module")
def oracle_scene(sky):
    tri = np.zeros((1, 9), np.float32)
    dummy = RefSceneData(
        tri_positions=tri, tri_normals=tri, tri_colors=tri,
        node_boxes=np.zeros((1, 8), np.float32), node_objects=np.zeros((1, 2), np.int32),
        hitmiss=np.full((8, 1, 2), -1, np.int32), tree_root=0, triangle_count=0, group_count=1,
    )
    return upload_scene(dummy, sky)


def test_env_derivatives_match_reference():
    D, gx, gy = _rays(41)
    got = envmap.env_derivatives(*(torch.from_numpy(x) for x in (D, gx, gy)))
    want = ref_envmap.env_derivatives(*(jnp.asarray(x) for x in (D, gx, gy)))
    for g, w in zip(got, want):
        # a quotient of f32 products: equal to a few ulp
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-12)
    # straight up: only denom_v is clamped, dudx divides by zero as in the reference
    up = torch.tensor([[0.0, 1.0, 0.0]])
    dudx, dvdx, _, _ = envmap.env_derivatives(up, torch.full((1, 3), 0.01), torch.zeros(1, 3))
    assert not torch.isfinite(dudx).all() and torch.isfinite(dvdx).all()


@pytest.mark.parametrize("aniso", [2, 4])
def test_aniso_lod_and_probes_match_reference(aniso):
    rng = np.random.default_rng(42)
    vals = [(10.0 ** rng.uniform(-3, 2, 500)).astype(np.float32) for _ in range(2)]
    vals += [rng.normal(size=500).astype(np.float32) * 1e-2 for _ in range(4)]
    vals[0][:5] = vals[1][:5]          # rho_x == rho_y: the x axis wins
    vals[1][5:10] = 0.0                # a degenerate minor axis
    rho, offs = envmap.aniso_lod_and_probes(*(torch.from_numpy(v) for v in vals), aniso)
    rho_w, offs_w = ref_envmap.aniso_lod_and_probes(*(jnp.asarray(v) for v in vals), aniso)
    assert len(offs) == envmap.ANISO_PROBES == ref_envmap.ANISO_PROBES == len(offs_w)
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_w), rtol=1e-6)
    for (tu, tv), (tu_w, tv_w) in zip(offs, offs_w):
        np.testing.assert_allclose(tu.numpy(), np.asarray(tu_w), rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(tv.numpy(), np.asarray(tv_w), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("width,base", [(256, 1024), (200, 1024), (512, 64)])
def test_pyramid_levels_equal_plane_pyramid(width, base):
    img = procedural_sky(width)
    texels, table = envmap.pack_env_pyramid(img, base)
    h0, w0 = int(table[0, 1]), int(table[0, 2])
    planes = pack_env_planes(img, base=(h0, w0))
    assert len(table) == planes.n_levels and table[-1, 1] == envmap.MIN_H
    assert texels.shape == (int((table[:, 1] * table[:, 2]).sum()), envmap.TEXEL)
    assert not texels[:, 3:].any()  # RGB and a zero pad
    grid = np.asarray(planes.planes)
    for l, (off, h, w) in enumerate(table):
        assert (h, w) == (int(planes.h_smem[l]), int(planes.w_smem[l]))
        level = texels[off : off + h * w, :3].reshape(h, w, 3)
        row0, blk = int(planes.off_smem[l]), int(planes.blk_smem[l])
        for c in range(3):  # phase-0 plane of channel c, inside its guard row
            p = row0 + c * blk
            np.testing.assert_array_equal(level[:, :, c], grid[p + 1 : p + 1 + h, :w])
    pyr = envmap.EnvPyramid.pack(img, base)
    assert pyr.levels == tuple(map(tuple, table.tolist()))
    assert torch.equal(pyr.table, torch.from_numpy(table))
    assert pyr.base == (h0, w0) and pyr.level0.shape == (h0, w0, envmap.TEXEL)
    assert pyr.level0.data_ptr() == pyr.texels.data_ptr()  # a view, not a copy


def test_mode0_matches_oracle(sky, oracle_scene):
    D, gx, gy = _rays(43)
    pyr = envmap.EnvPyramid.pack(sky)
    zeros = jnp.zeros_like(jnp.asarray(D))
    want = np.asarray(ref_envmap.sample_environment(oracle_scene, jnp.asarray(D), zeros, zeros, which=0))
    got = env_sample(pyr, torch.from_numpy(D)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert env_sample(pyr, torch.zeros((0, 3))).shape == (0, 3)


@pytest.mark.parametrize("aniso", [1, 4])
def test_grad_mode_matches_oracle_up_to_the_last_level(sky, oracle_scene, aniso):
    D, gx, gy = _rays(44)
    pyr = envmap.EnvPyramid.pack(sky)
    assert pyr.n_levels == 4
    tD, tgx, tgy = (torch.from_numpy(x) for x in (D, gx, gy))
    got = env_sample(pyr, tD, tgx, tgy, grad=True, aniso=aniso).numpy()
    want = np.asarray(ref_envmap.sample_environment(
        oracle_scene, jnp.asarray(D), jnp.asarray(gx), jnp.asarray(gy), which=1, aniso=aniso))
    assert np.isfinite(got).all()

    dudx, dvdx, dudy, dvdy = envmap.env_derivatives(tD, tgx, tgy)
    h0, w0 = pyr.base
    rho_x = torch.sqrt((dudx * w0) ** 2 + (dvdx * h0) ** 2)
    rho_y = torch.sqrt((dudy * w0) ** 2 + (dvdy * h0) ** 2)
    rho = torch.maximum(rho_x, rho_y) if aniso == 1 else \
        envmap.aniso_lod_and_probes(rho_x, rho_y, dudx, dvdx, dudy, dvdy, aniso)[0]
    lod = torch.log2(torch.clamp(rho, min=1e-12)).numpy()
    inside = lod <= pyr.n_levels - 1 - 1e-3   # clear of the clip point itself
    assert 0.5 < inside.mean() < 0.98 and (lod < 0).any()  # both regimes are exercised
    np.testing.assert_allclose(got[inside], want[inside], rtol=2e-4, atol=2e-4)

    # beyond the last level the lookup is that level's plain bilinear
    beyond = lod >= pyr.n_levels - 1
    if aniso == 1:
        u, v = envmap.env_coords(tD)
        last = envmap.bilinear_level(
            pyr.texels, pyr.table, torch.full_like(u, pyr.n_levels - 1, dtype=torch.long), u, v)
        np.testing.assert_allclose(got[beyond], last.numpy()[beyond], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("aniso", [1, 4])
def test_grad_mode_along_the_y_axis_is_nan_as_the_reference(sky, oracle_scene, aniso):
    """Directions exactly along +y and -y (x = z = 0) with non-zero
    differentials: du/dx is 0/0, and the reference's
    ``sample_environment(which=1)`` is NaN in all three channels.  The
    plain version raises nothing, is NaN exactly where the reference is,
    and equals it on the other rays (narrow footprints, lod inside the
    port's levels); mode 0 stays finite there."""
    rng = np.random.default_rng(49)
    n = 400
    D = rng.normal(size=(n, 3)).astype(np.float32)
    D[:, 1] *= 0.5
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    D[::20] = [0.0, 1.0, 0.0]
    D[10::20] = [0.0, -1.0, 0.0]
    scale = (10.0 ** rng.uniform(-4.0, -2.0, size=(n, 1))).astype(np.float32)
    gx = rng.normal(size=(n, 3)).astype(np.float32) * scale
    gy = rng.normal(size=(n, 3)).astype(np.float32) * scale * 0.5
    pyr = envmap.EnvPyramid.pack(sky)
    tD, tgx, tgy = (torch.from_numpy(x) for x in (D, gx, gy))
    got = env_sample(pyr, tD, tgx, tgy, grad=True, aniso=aniso).numpy()
    want = np.asarray(ref_envmap.sample_environment(
        oracle_scene, jnp.asarray(D), jnp.asarray(gx), jnp.asarray(gy), which=1, aniso=aniso))
    axis = (D[:, 0] == 0) & (D[:, 2] == 0)
    assert axis.sum() == 40 and np.isnan(want).any(-1).sum() == 40
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[axis]).all() and np.isfinite(got[~axis]).all()
    np.testing.assert_allclose(got[~axis], want[~axis], rtol=2e-4, atol=2e-4)
    assert np.isfinite(env_sample(pyr, tD).numpy()).all()


def test_wrap_is_exact_for_every_finite_coordinate():
    """``wrap`` is floor(x) mod n for power-of-two n, exactly, far past
    2^31 (a grad probe near a pole reaches such x), and sends a
    non-finite x to index 0."""
    rng = np.random.default_rng(50)
    ints = rng.integers(-(2**40), 2**40, size=2000)
    x = np.concatenate([ints.astype(np.float32), np.float32([3.0e38, -3.0e38, 2.0**24 + 2, -1.0])])
    for n in (16, 256, 2048):
        got = envmap.wrap(torch.from_numpy(x), n).numpy()
        want = np.array([int(v) % n for v in x.astype(np.float64)])
        np.testing.assert_array_equal(got, want)
    special = torch.tensor([float("nan"), float("inf"), -float("inf")])
    assert envmap.wrap(special, 64).tolist() == [0, 0, 0]


def test_grad_mode_needs_differentials(sky):
    pyr = envmap.EnvPyramid.pack(sky)
    D = torch.from_numpy(_rays(45, 16)[0])
    with pytest.raises(ValueError, match="dDdx"):
        env_sample(pyr, D, grad=True)
    with pytest.raises(ValueError, match="device"):
        env_sample(pyr, D.to("meta"))
    with pytest.raises(ValueError, match="aniso"):
        env_sample(pyr, D, D, D, grad=True, aniso=0)


@pytest.mark.parametrize("grad,aniso", [(False, 1), (True, 1), (True, 4)])
def test_plain_sampler_marks_the_texels_it_reads(sky, grad, aniso):
    """``touched`` holds exactly the texels the lookup depends on: the
    result is unchanged (bit for bit) when every other texel is
    overwritten, mode 0 touches level 0 only, and one direction touches
    at most 4 texels per fetch.  ``fetches`` counts one fetch a ray in
    mode 0 and, in grad mode, one or two a probe."""
    from shader_ray_tpu_torch.ops.env_kernel import env_sample_plain

    pyr = envmap.EnvPyramid.pack(sky)
    D, gx, gy = (torch.from_numpy(x) for x in _rays(47, 500))
    touched = torch.zeros(pyr.texels.shape[0], dtype=torch.bool)
    fetches = torch.zeros((), dtype=torch.long)
    want = env_sample_plain(pyr, D, gx, gy, grad=grad, aniso=aniso, touched=touched,
                            fetches=fetches)
    assert touched.any() and not touched.all()
    probes = envmap.ANISO_PROBES if aniso > 1 else 1
    if grad:
        assert probes * 500 < int(fetches) < 2 * probes * 500
    else:
        assert int(fetches) == 500
    if not grad:
        h, w = pyr.base
        assert not touched[h * w:].any()
    scrambled = envmap.EnvPyramid(torch.where(touched[:, None], pyr.texels, -7.0), pyr.levels)
    assert torch.equal(env_sample_plain(scrambled, D, gx, gy, grad=grad, aniso=aniso), want)
    one = torch.zeros_like(touched)
    env_sample_plain(pyr, D[:1], gx[:1], gy[:1], grad=grad, aniso=aniso, touched=one)
    fetches = (2 * (envmap.ANISO_PROBES if aniso > 1 else 1)) if grad else 1
    assert 1 <= int(one.sum()) <= 4 * fetches


@pytest.mark.parametrize("aniso", [1, 4])
def test_lod_on_a_level_needs_no_upper_level(sky, aniso):
    """A footprint whose lod clamps to level 0 gives the upper level of
    its trilinear weight 0: the lookup needs level 0 only (one fetch a
    probe), and equals the level-0 bilinear fetch at the probes."""
    from shader_ray_tpu_torch.ops.env_kernel import env_sample_plain

    pyr = envmap.EnvPyramid.pack(sky)
    D, gx, gy = (torch.from_numpy(x) for x in _rays(53, 500))
    gx, gy = gx * 1e-6, gy * 1e-6   # rho < 1 at every ray: lod 0
    touched = torch.zeros(pyr.texels.shape[0], dtype=torch.bool)
    fetches = torch.zeros((), dtype=torch.long)
    got = env_sample_plain(pyr, D, gx, gy, grad=True, aniso=aniso, touched=touched,
                           fetches=fetches)
    h, w = pyr.base
    assert touched[: h * w].any() and not touched[h * w:].any()
    assert int(fetches) == 500 * (envmap.ANISO_PROBES if aniso > 1 else 1)
    if aniso == 1:
        u, v = envmap.env_coords(D)
        torch.testing.assert_close(got, envmap.bilinear_level0(pyr.level0, u, v), rtol=0, atol=0)
