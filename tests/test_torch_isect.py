"""The Moller-Trumbore leaf form of the port's 8-wide walk
(``Config.leaf_isect = "mt"``) on the CPU (the kernels' plain versions)
against the reference.

The config field has the reference's default, choices and environment
variable.  The packed test rows are the reference's ``"mt"`` leaf records
bit for bit: v0 as stored, e0 = v1 - v0 and e1 = v0 - v2 as the f32
differences slot_hit forms from the record's vertex lanes, the normal
terms n0, n1 - n0, n2 - n0 likewise, each triangle found through the
record's tribase.  The plain walk holds to the Pallas wide kernel run
with ``isect="mt"`` (interpret mode, one 1024-ray tile; the tolerances of
tests/test_torch_trace.py: t at rtol 1e-5 plus 1e-6, ids equal but at
exact ties, bad flags equal) and to the brute-force oracle.  A 64 x 64
frame at ``which`` 0 and 1 holds to the reference's wavefront engine
(which tests leaves with Moller-Trumbore too) within
tests/test_torch_frame.py's tolerance: mean abs < 2e-3 and >= 99% of
pixels within 2e-2.  The App takes ``set leaf_isect mt`` as a pack-time
knob, and the failure dump names the field."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models.fixtures import bunny_class_scene, procedural_sky, uv_sphere
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.models.world import get_shader_data as ref_get_shader_data
from shader_ray_tpu.models.world import make_world as ref_make_world
from shader_ray_tpu.ops.pallas.pack import GROUP_ROWS, leaf_layout, pack_leaf_groups
from shader_ray_tpu.ops.pallas.pack_wide import pack_scene_wide as ref_pack_scene_wide
from shader_ray_tpu.ops.pallas.packet_wide import packet_trace_wide
from shader_ray_tpu.ops.reference import intersect_brute
from shader_ray_tpu.ops.render import RenderStatics as RefStatics
from shader_ray_tpu.ops.render import default_frame_params as ref_default_params
from shader_ray_tpu.ops.render import render_frame as ref_render_frame
from shader_ray_tpu.ops.scene import upload_scene
from shader_ray_tpu.utils import mat4 as ref_mat4
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.convert import frame_params_from_numpy, packed_from_numpy, scene_data_from_numpy
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.ops import frame_kernel as fk
from shader_ray_tpu_torch.ops.pack_wide import ISECTS
from shader_ray_tpu_torch.ops.render import RenderStatics
from shader_ray_tpu_torch.ops.trace_kernel import INFINITELY_FAR, launch_name, trace_wide, walk_plain
from shader_ray_tpu_torch.utils import kerneldiag
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MT = Config(leaf_isect="mt")
N = 64


def _ref_data(pos, nrm=None):
    cfg = RefConfig()
    cfg.use_native = "never"
    return ref_get_shader_data(ref_make_world(RefTriangleSet.from_arrays(pos, nrm), cfg), cfg)


def _rays(seed: int, n: int = 1024):
    """Seeded rays, among them exactly axis-aligned ones and the default
    light direction (0, 0, 1), a 70% active mask."""
    rng = np.random.default_rng(seed)
    P = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    D = rng.normal(size=(n, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    axes = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                    np.float32)
    D[: 6 * 20] = np.repeat(axes, 20, axis=0)
    D[6 * 20 : 6 * 20 + 40] = [0.0, 0.0, 1.0]
    return P, D, rng.uniform(size=n) < 0.7


def _check_hits(t, which, t_ref, which_ref):
    hit = t < INFINITELY_FAR
    np.testing.assert_array_equal(hit, t_ref < INFINITELY_FAR)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5, atol=1e-6)
    differ = hit & (which != which_ref)
    assert (np.abs(t[differ] - t_ref[differ]) < 1e-6).all(), "id mismatch that is not a tie"
    assert differ.mean() < 0.02
    return hit


def test_config_leaf_isect_matches_reference(monkeypatch):
    ref, port = RefConfig(), Config()
    assert port.leaf_isect == ref.leaf_isect == "woop"
    assert set(Config._CHOICES["leaf_isect"]) == set(RefConfig._CHOICES["leaf_isect"]) == set(ISECTS)
    for value in ISECTS:
        monkeypatch.setenv("SRT_ISECT", value)
        assert Config.from_env().leaf_isect == RefConfig.from_env().leaf_isect == value
    monkeypatch.setenv("SRT_ISECT", "plucker")
    with pytest.raises(ValueError, match="leaf_isect"):
        Config.from_env()
    with pytest.raises(ValueError, match="leaf_isect"):
        Config(leaf_isect="plucker").validate()


def test_mt_rows_equal_reference_records():
    ref = _ref_data(*bunny_class_scene(1000))
    port = packed_from_numpy(vars(ref), procedural_sky(32), "wide", MT)
    assert port.isect == "mt" and port.to("cpu").isect == "mt"
    woop = packed_from_numpy(vars(ref), procedural_sky(32), "wide")
    # the same node table (int32 bits: meta words read as floats may be NaN)
    assert torch.equal(port.nodes.view(torch.int32), woop.nodes.view(torch.int32))
    assert torch.equal(port.normals, woop.normals)
    leaves, tribase, _, counts, L = pack_leaf_groups(ref, isect="mt")
    record, per_group = leaf_layout("mt")
    rows, nrms = port.leaves.numpy(), port.normals.numpy()
    leaf_ids = np.nonzero(ref.node_objects[:, 1] > 0)[0]
    seen = 0
    for row, g in enumerate(leaf_ids):
        grp, sub = divmod(row, per_group)
        for k in range(int(counts[g])):
            rec = leaves[grp * GROUP_ROWS + k, sub * record : sub * record + record]
            tri = int(tribase[row]) + k
            v0, v1, v2 = rec[0:3], rec[3:6], rec[6:9]
            n0, n1, n2 = rec[9:12], rec[12:15], rec[15:18]
            got = rows[tri].reshape(3, 4)
            assert got[:, 3].tobytes() == np.zeros(3, np.float32).tobytes()
            assert got[0, :3].tobytes() == v0.tobytes()
            assert got[1, :3].tobytes() == (v1 - v0).tobytes()
            assert got[2, :3].tobytes() == (v0 - v2).tobytes()
            assert nrms[tri].tobytes() == np.concatenate(
                [n0, n1 - n0, n2 - n0, np.zeros(3, np.float32)]).tobytes()
            seen += 1
    assert seen == ref.triangle_count == rows.shape[0]


def test_walk_plain_mt_matches_pallas_wide_kernel():
    pos, nrm = uv_sphere(lat=10, lon=14)
    ref = _ref_data(pos, nrm)
    env = procedural_sky(32)
    P, D, active = _rays(41)
    want = packet_trace_wide(
        ref_pack_scene_wide(ref, env, isect="mt"), jnp.asarray(P), jnp.asarray(D),
        active=jnp.asarray(active), tile=1024, interpret=True,
    )
    packed = packed_from_numpy(vars(ref), env, "wide", MT)
    got = trace_wide(packed, torch.from_numpy(P), torch.from_numpy(D), torch.from_numpy(active))
    hit = _check_hits(got.t.numpy(), got.which.numpy(), np.asarray(want.t), np.asarray(want.which))
    assert not hit[~active].any() and hit.mean() > 0.1
    same = hit & (got.which.numpy() == np.asarray(want.which))
    np.testing.assert_allclose(got.normal.numpy()[same], np.asarray(want.normal)[same],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.bad.numpy(), np.asarray(want.bad))


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_plain_mt_matches_brute_force(any_hit):
    ref = _ref_data(*bunny_class_scene(1000))
    packed = packed_from_numpy(vars(ref), procedural_sky(32), "wide", MT)
    P, D, _ = _rays(42, 2048)
    all_on = torch.ones(P.shape[0], dtype=torch.bool)
    w = walk_plain(packed, torch.from_numpy(P), torch.from_numpy(D), all_on, any_hit)
    tb, wb, _, _ = intersect_brute(ref.tri_positions.reshape(-1, 3, 3), P, D)
    if any_hit:
        np.testing.assert_array_equal((w.t == 0.0).numpy(), tb < INFINITELY_FAR)
    else:
        _check_hits(w.t.numpy(), w.which.numpy(), tb, wb)
    assert not w.bad.any()
    # the same work as the Woop walk: the forms differ only in the test
    woop = walk_plain(packed_from_numpy(vars(ref), procedural_sky(32), "wide"),
                      torch.from_numpy(P), torch.from_numpy(D), all_on, any_hit)
    for f in ("steps", "leafs", "tris"):
        assert abs(int(getattr(w, f).sum()) - int(getattr(woop, f).sum())) <= \
            1e-3 * int(getattr(woop, f).sum()), f


@pytest.fixture(scope="module")
def sphere():
    """A smooth sphere, diffuse red with shadows under a tilted light and
    30% specular: the reference scene and params, the port's params and
    its mt Renderer on the CPU."""
    pos, nrm = uv_sphere(lat=12, lon=16)
    ref = _ref_data(pos, nrm)
    env = procedural_sky(1024)
    jp = ref_default_params()._replace(
        camera_matrix=jnp.asarray(ref_mat4.make_translation(0.0, 0.0, 3.2)),
        light_dir=jnp.asarray(np.array([0.36, 0.48, 0.8], np.float32)),
        diffuse_color=jnp.asarray(np.array([0.8, 0.2, 0.2], np.float32)),
        specular_color=jnp.asarray(np.array([0.3, 0.3, 0.3], np.float32)),
    )
    tp = frame_params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()})
    renderer = Renderer(scene_data_from_numpy(vars(ref)), env, MT, device="cpu")
    return upload_scene(ref, env), jp, tp, renderer


@pytest.mark.parametrize("which,aniso", [(0, 1), (1, 4)])
def test_mt_frame_matches_wavefront_engine(sphere, which, aniso):
    scene, jp, tp, renderer = sphere
    assert renderer.packed.isect == "mt"
    kw = dict(width=N, height=N, which=which, env_aniso=aniso)
    statics = RefStatics(tile_size=N * N, **kw)
    want = np.asarray(jax.jit(lambda s, p: ref_render_frame(s, p, statics))(scene, jp))
    before = dict(fk._build.LAUNCHES)
    got = renderer.make_fn(RenderStatics(**kw))(tp).numpy()
    assert dict(fk._build.LAUNCHES) == before  # the CPU runs the plain version, no kernel
    assert got.shape == (N, N, 3) and np.isfinite(got).all() and got.std() > 1e-3
    err = np.abs(got - want)
    assert err.mean() < 2e-3, err.mean()
    assert (err.max(axis=-1) <= 2e-2).mean() >= 0.99, (err.max(axis=-1) > 2e-2).mean()


def test_app_takes_leaf_isect_as_a_pack_time_knob():
    import io

    from shader_ray_tpu_torch.app.driver import App
    from shader_ray_tpu_torch.models.fixtures import box
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world

    cfg = Config()
    world = make_world(TriangleSet.from_arrays(box()), cfg)
    app = App(world, Renderer(get_shader_data(world), procedural_sky(32), cfg, device="cpu"), cfg,
              width=8, height=8)
    out = io.StringIO()
    assert app.set_knob("leaf_isect", "mt", file=out)
    assert "leaf_isect = mt" in out.getvalue() and "pack-time knob" in out.getvalue()
    assert cfg.leaf_isect == "mt"
    assert app.renderer.packed.isect == "woop"  # packed before the edit: takes effect on a reload
    out = io.StringIO()
    assert not app.set_knob("leaf_isect", "plucker", file=out) and cfg.leaf_isect == "mt"
    assert "leaf_isect" in out.getvalue()


def test_failure_dump_names_leaf_isect():
    ref = _ref_data(*bunny_class_scene(200))
    packed = packed_from_numpy(vars(ref), procedural_sky(32), "wide", MT)
    text = kerneldiag.describe_failure(RuntimeError("frame_kernel_mt launch failed: CUDA error 1"),
                                       cfg=MT, packed=packed,
                                       settings=fk.FrameSettings(width=8, height=8))
    assert "leaf_isect='mt'" in text and "isect=mt" in text
    assert launch_name("frame_kernel", "mt") == "frame_kernel_mt"
    assert launch_name("trace_wide", "woop") == "trace_wide"
    with pytest.raises(ValueError, match="leaf test"):
        trace_wide(dataclasses.replace(packed, isect="plucker"), torch.zeros((1, 3)),
                   torch.ones((1, 3)))
