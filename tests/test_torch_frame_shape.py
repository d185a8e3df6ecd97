"""The frame kernel's launch shape (``Config.frame_tile``, ``frame_warp``;
``FrameSettings.tile_w``, ``warp_map``) on the CPU, through the plain
version.

Under each of the 8 shapes (widths 8, 16, 32, 64; warp maps "rows" and
"bricks") a frame's colour and counter row equal the default shape's bit
for bit, on a frame whose sides are no whole number of tiles; its tile
rows sum to the counter row and equal the plain walks' per-ray counts
binned by hand into that shape's tiles.  A Renderer reads the shape from
its config at each call, and a non-default shape's frame is held to the
reference's wavefront engine with the frame-parity tolerance of
tests/test_torch_fused_grad.py.  A shape the kernel has not raises."""

import itertools

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
from shader_ray_tpu.ops.render import render_frame as ref_render_frame
from shader_ray_tpu.ops.scene import upload_scene
from shader_ray_tpu.utils import mat4 as ref_mat4
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.convert import frame_params_from_numpy, scene_data_from_numpy
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.ops import engine_frame
from shader_ray_tpu_torch.ops import frame_kernel as fk
from shader_ray_tpu_torch.ops.render import RenderStatics
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPES = list(itertools.product(fk.TILE_WIDTHS, fk.WARP_MAPS))
W, H = 72, 40  # no whole number of tiles of any width but 8 across


@pytest.fixture(scope="module")
def sphere():
    """The sphere fixture of tests/test_torch_fused_grad.py: the reference
    scene and params, the port's params and a CPU Renderer."""
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
    r = Renderer(scene_data_from_numpy(vars(ref)), env, device="cpu")
    return upload_scene(ref, env), jp, tp, r


@pytest.fixture(scope="module")
def default_frame(sphere):
    """Colour and counter row of the W x H frame at the default shape."""
    _, _, tp, r = sphere
    fs = engine_frame.frame_settings(RenderStatics(width=W, height=H), Config())
    assert (fs.tile_w, fs.warp_map) == (16, "rows")
    uni = engine_frame.pack_uniforms(tp)
    return fk.frame_plain(r.packed, uni, engine_frame.frame_jitter(tp), fs)


@pytest.mark.parametrize("tile_w,warp_map", SHAPES)
def test_each_shape_gives_the_default_frame_and_its_own_tile_rows(sphere, default_frame, tile_w,
                                                                  warp_map):
    _, _, tp, r = sphere
    fs = engine_frame.frame_settings(RenderStatics(width=W, height=H),
                                     Config(frame_tile=tile_w, frame_warp=warp_map))
    tw, th = fs.tile()
    assert tw * th == fk.BLOCK and tw == tile_w
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    assert fs.n_tiles() == tiles_x * tiles_y
    rows = torch.full((fs.n_tiles(), 1 + 3 * fs.phases()), -1, dtype=torch.long)
    probe = {}
    uni = engine_frame.pack_uniforms(tp)
    colour, counters = fk.frame_plain(r.packed, uni, engine_frame.frame_jitter(tp), fs, probe,
                                      tile_rows=rows)
    assert torch.equal(colour, default_frame[0]) and torch.equal(counters, default_frame[1])
    assert torch.equal(rows.sum(0), counters)
    # per-ray counts (K = 1: ray = pixel), padded to whole tiles, summed a tile
    def binned(per_ray):
        img = torch.zeros((tiles_y * th, tiles_x * tw), dtype=torch.long)
        img[:H, :W] = per_ray.reshape(H, W)
        return img.reshape(tiles_y, th, tiles_x, tw).sum((1, 3)).reshape(-1)

    for p, w in enumerate(probe["walks"]):
        for c, counts in enumerate((w.steps, w.leafs, w.tris)):
            assert torch.equal(rows[:, 1 + 3 * p + c], binned(counts.long()))
    # every tile casts its primaries, and a tile of the sphere casts more
    # rays than the corner tile of sky
    assert int(rows[:, 0].max()) > int(rows[0, 0]) >= 1


def test_the_renderer_reads_the_shape_at_each_call(sphere):
    _, _, tp, r = sphere
    st = RenderStatics(width=48, height=64)
    stats = r.make_stats_fn(st)
    frame = r.make_fn(st._replace(do_tonemap=False))
    want = frame(tp)
    assert stats(tp).shape[0] == 3 * 4  # tiles of 16 x 16
    r.cfg.frame_tile, r.cfg.frame_warp = 64, "bricks"
    try:
        assert stats(tp).shape[0] == 1 * 16  # tiles of 64 x 4
        assert torch.equal(frame(tp), want)
        assert r._settings(st)[-2:] == (64, "bricks")
        r.cfg.frame_tile = 12  # the Renderer does not validate; the frame does
        with pytest.raises(ValueError, match="tile_w=12"):
            frame(tp)
    finally:
        r.cfg.frame_tile, r.cfg.frame_warp = 16, "rows"


def test_a_shape_the_kernel_has_not_raises():
    assert Config.FRAME_TILES == fk.TILE_WIDTHS and Config._CHOICES["frame_warp"] == fk.WARP_MAPS
    for bad in (dict(tile_w=12), dict(tile_w=128), dict(warp_map="columns")):
        with pytest.raises(ValueError, match="frame_kernel: tile_w"):
            fk.FrameSettings(width=8, height=8, **bad).n_tiles()
    for bad in (dict(frame_tile=12), dict(frame_warp="columns")):
        with pytest.raises(ValueError):
            Config(**bad).validate()


def test_a_non_default_shape_matches_the_wavefront_engine(sphere):
    scene, jp, tp, r = sphere
    n = 64
    statics = RefStatics(width=n, height=n, tile_size=n * n)
    want = np.asarray(jax.jit(lambda s, p: ref_render_frame(s, p, statics))(scene, jp))
    r.cfg.frame_tile, r.cfg.frame_warp = 32, "bricks"
    try:
        got = r.make_fn(RenderStatics(width=n, height=n))(tp).numpy()
    finally:
        r.cfg.frame_tile, r.cfg.frame_warp = 16, "rows"
    err = np.abs(got - want)
    assert got.shape == (n, n, 3) and np.isfinite(got).all() and got.std() > 1e-3
    assert err.mean() < 2e-3, err.mean()
    assert (err.max(axis=-1) <= 2e-2).mean() >= 0.99
