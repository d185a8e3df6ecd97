"""The fused frame kernel's grad-env modes and the stats fn, on
``Renderer(device="cpu")`` (the kernels' plain versions).

``which = 1`` (textureGrad env, ``env_aniso`` 1 and 4) and ``which = 2``
(the dY picture) now run through the fused frame kernel's ``with_grads``
form: raygen seeds the ray differentials, each hit transfers them, and
the env term reads them.  Their frames are held to the reference's
wavefront engine on the sphere fixture (mean abs < 2e-3 and >= 99% of
pixels within 2e-2; ``which = 2`` untonemapped, where the same numbers
bound |du|, |dv| x 100; ``which = 1`` against the oracle's deeper mip
chain, as tests/test_torch_unfused.py holds the unfused route) and to the
port's unfused route (mean abs <= 1e-6 on linear colour: the same walk,
the differentials carried in another order of f32 operations).  A ray
exactly along +y is NaN in the grad modes on both routes.

The stats fn returns the fused kernel's counter row of each 16 x 16
pixel tile of a ``which = 0`` frame; its column sums are the frame's
row, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models.fixtures import procedural_sky, uv_sphere
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.models.world import get_shader_data, make_world
from shader_ray_tpu.ops.pallas.packet_mega import stats_phases as ref_stats_phases
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

N = 64
GRAD_MODES = [(1, 1), (1, 4), (2, 1)]  # (which, env_aniso)


def assert_frame_close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.mean() < 2e-3, err.mean()
    assert (err.max(axis=-1) <= 2e-2).mean() >= 0.99, (err.max(axis=-1) > 2e-2).mean()


@pytest.fixture(scope="module")
def sphere():
    """The sphere fixture of tests/test_torch_unfused.py: smooth normals,
    diffuse red with shadows under a tilted light, 30% specular so the
    env term shows; the reference scene and params, the port's params,
    and the port's renderers on the fused and both unfused routes."""
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
        "binary": Renderer(data, env, Config(packet_kernel="binary"), device="cpu"),
    }
    return upload_scene(ref, env), jp, tp, renderers


@pytest.mark.parametrize("which,aniso", GRAD_MODES)
def test_fused_grad_frame_matches_wavefront_engine(sphere, which, aniso):
    scene, jp, tp, renderers = sphere
    tonemap = which == 1
    kw = dict(width=N, height=N, which=which, env_aniso=aniso, do_tonemap=tonemap)
    r = renderers["fused"]
    assert engine_frame.fused_route(r.packed, RenderStatics(**kw), r.cfg)
    statics = RefStatics(tile_size=N * N, **kw)
    # jitted: eager, render_frame dispatches its while-loops op by op
    want = np.asarray(jax.jit(lambda s, p: ref_render_frame(s, p, statics))(scene, jp))
    got = r.make_fn(RenderStatics(**kw))(tp).numpy()
    assert got.shape == (N, N, 3) and np.isfinite(got).all()
    assert_frame_close(got, want)
    assert got.std() > 1e-3  # a picture, not a constant


@pytest.mark.parametrize("which,aniso", GRAD_MODES)
def test_fused_grad_frame_matches_unfused_route(sphere, which, aniso):
    _, _, tp, renderers = sphere
    linear = RenderStatics(width=N, height=N, which=which, env_aniso=aniso, do_tonemap=False)
    fused = renderers["fused"].make_fn(linear)(tp)
    unfused = renderers["unfused"].make_fn(linear)(tp)
    assert float((fused - unfused).abs().mean()) <= 1e-6
    # the grad modes' env term is not which=0's
    plain = renderers["fused"].make_fn(linear._replace(which=0))(tp)
    assert float((fused - plain).abs().mean()) > 1e-4


def test_fused_grad_progressive_is_mean_of_frames(sphere):
    _, _, tp, renderers = sphere
    r = renderers["fused"]
    linear = RenderStatics(width=32, height=32, do_tonemap=False, which=1, env_aniso=4)
    prog = r.make_progressive_fn(linear, 4)(tp)
    frame = r.make_fn(linear)
    frames = [frame(tp._replace(pixel_jitter=torch.from_numpy(j)))
              for j in engine_frame.halton_jitters(4)]
    torch.testing.assert_close(prog, (frames[0] + frames[1] + frames[2] + frames[3]) / 4,
                               rtol=1e-6, atol=1e-7)
    assert not torch.equal(frames[0], frames[1])


@pytest.mark.parametrize("which,aniso", [(0, 1), *GRAD_MODES])
def test_ray_along_y_is_nan_where_the_unfused_route_has_it(sphere, which, aniso):
    """The camera looks up +y; at the jitter (0.5, 0.5) the centre
    pixel's ray is exactly (0, 1, 0) and misses: 0/0 in du/dx makes its
    grad-mode env term NaN on both routes (as in the reference), and
    which=0 stays finite."""
    _, _, tp, renderers = sphere
    up = torch.tensor([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                      dtype=torch.float32)
    params = tp._replace(camera_normal_matrix=up, pixel_jitter=torch.tensor([0.5, 0.5]))
    linear = RenderStatics(width=N, height=N, which=which, env_aniso=aniso, do_tonemap=False)
    fused = renderers["fused"].make_fn(linear)(params)
    unfused = renderers["unfused"].make_fn(linear)(params)
    nan = torch.isnan(fused)
    assert torch.equal(nan, torch.isnan(unfused))
    expect = torch.zeros((N, N), dtype=torch.bool)
    expect[N // 2 - 1, N // 2 - 1] = which != 0
    assert torch.equal(nan.any(-1), expect)
    assert float((fused - unfused)[~nan].abs().mean()) <= 1e-6


def test_stats_fn_rows_sum_to_the_frame_row(sphere):
    _, _, tp, renderers = sphere
    r = renderers["fused"]
    st = RenderStatics(width=N, height=N)
    rows = r.make_stats_fn(st)(tp)
    phases = fk.stats_phases(st.bounce_count, st.cast_shadows, st.enable_diffuse)
    n_tiles = (N // fk.TILE) ** 2
    assert rows.dtype == torch.long and rows.shape == (n_tiles, 1 + 3 * len(phases))
    fs = engine_frame.frame_settings(st, r.cfg)
    uni = engine_frame.pack_uniforms(tp)
    block = engine_frame.fill_uniforms(np.zeros(fk.UNI_BLOCK, np.float32), tp)
    _, frame_row = fk.frame_kernel(r.packed, block, engine_frame.frame_jitter(tp), fs)
    assert torch.equal(rows.sum(0), frame_row)
    assert int(rows[:, 0].sum()) == r.make_count_fn(st)(tp)
    # a row is its tile's: each phase's per-ray counts of the plain walks,
    # summed over 16 x 16 pixel blocks, tiles row-major
    probe = {}
    fk.frame_plain(r.packed, uni, engine_frame.frame_jitter(tp), fs, probe)
    t = N // fk.TILE

    def per_tile(per_ray):
        return per_ray.reshape(t, fk.TILE, t, fk.TILE).sum((1, 3)).reshape(-1)

    for p, w in enumerate(probe["walks"]):
        for c, counts in enumerate((w.steps, w.leafs, w.tris)):
            assert torch.equal(rows[:, 1 + 3 * p + c], per_tile(counts))
    assert bool((rows[:, 0] >= fk.TILE * fk.TILE).all())  # every primary is cast
    assert int(rows[:, 0].min()) < int(rows[:, 0].max())
    # the stats fn renders which=0 whatever the statics say, and the walks
    # (so the rows) are the same in every env mode
    torch.testing.assert_close(r.make_stats_fn(st._replace(which=1, env_aniso=4))(tp), rows,
                               rtol=0, atol=0)
    grad_rows = torch.empty_like(rows)
    fk.frame_plain(r.packed, uni, engine_frame.frame_jitter(tp),
                   fs._replace(which=1, env_aniso=4), tile_rows=grad_rows)
    assert torch.equal(grad_rows, rows)


@pytest.mark.parametrize("bounces", [0, 1, 2, 3])
def test_stats_phases_match_the_reference(bounces):
    for shadows in (False, True):
        for diffuse in (False, True):
            phases = fk.stats_phases(bounces, shadows, diffuse)
            assert phases == ref_stats_phases(bounces, shadows, diffuse)
            fs = fk.FrameSettings(width=8, height=8, bounce_count=bounces, cast_shadows=shadows,
                                  enable_diffuse=diffuse)
            assert fs.phases() == len(phases)


def test_stats_fn_is_none_off_the_fused_route(sphere):
    _, _, _, renderers = sphere
    st = RenderStatics(width=N, height=N)
    assert renderers["unfused"].make_stats_fn(st) is None
    assert renderers["binary"].make_stats_fn(st) is None
    assert renderers["fused"].make_stats_fn(st._replace(which=2)) is not None


def test_frame_plain_probe_reports_the_env_call_differentials(sphere):
    """In a grad mode the probe also hands out the differentials of the
    env call's rays: the unit primary direction's seeded ones where the
    primary missed (orthogonal to it), the frame unchanged."""
    _, _, tp, renderers = sphere
    packed = renderers["fused"].packed
    uni = engine_frame.pack_uniforms(tp)
    jit = torch.zeros((1, 2))
    fs = fk.FrameSettings(width=32, height=32, which=1, env_aniso=4)
    probe = {}
    col, _ = fk.frame_plain(packed, uni, jit, fs, probe)
    assert torch.equal(col, fk.frame_plain(packed, uni, jit, fs)[0])
    for key in ("env_D", "env_dDdx", "env_dDdy"):
        assert probe[key].shape == (32 * 32, 3) and torch.isfinite(probe[key]).all()
    missed = probe["walks"][0].t >= fk.INFINITELY_FAR
    assert missed.any() and not missed.all()
    for key in ("env_dDdx", "env_dDdy"):
        along = (probe[key][missed] * probe["env_D"][missed]).sum(1)
        assert float(along.abs().max()) < 1e-6
        assert float(probe[key][missed].norm(dim=1).min()) > 0.0
