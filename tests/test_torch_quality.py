"""The greedy 8-wide collapse and the tree-quality simulator against the
JAX package: ``pack_wide._collapse_greedy`` gives the reference's wide
nodes (children, ids, depths) on the sphere and bunny-class scenes, and
``pack_scene_wide`` under ``Config.collapse = "greedy"`` the reference
greedy pack's node count, stack bound, child sets and octant orders;
``models/quality.py``'s ``simulate_packet_walk`` (closest and any-hit,
hits and walk counts) and ``simulate_frame`` (per-phase packets, steps,
leaf visits and slot tests) equal the reference's on the same SceneData,
for ``splits`` object and sbvh and ``collapse`` sah and greedy.  A
greedy-collapsed frame on ``Renderer(device="cpu")`` is held to the
committed sphere golden (the reference wavefront engine's frame) at the
tolerance tests/test_torch_frame.py holds the SAH tables to, and to the
SAH tables' frame."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models import quality as ref_quality
from shader_ray_tpu.ops.pallas.pack_wide import _collapse_greedy as ref_collapse_greedy
from shader_ray_tpu.ops.pallas.pack_wide import pack_scene_wide as ref_pack_scene_wide
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.models import quality
from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky, uv_sphere
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.ops.pack_wide import COUNT_SHIFT, FIRST_MASK, _collapse_greedy, pack_scene_wide
from shader_ray_tpu_torch.ops.render import RenderStatics, default_frame_params
from shader_ray_tpu_torch.utils import mat4
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sphere_gold_64.npy")
SCENES = {
    "sphere": lambda: uv_sphere(lat=12, lon=24),
    "bunny_class": lambda: bunny_class_scene(3000),
}


def _data(scene: str, splits: str = "object"):
    pos, nrm = SCENES[scene]()
    return get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm), Config(splits=splits)))


def _ref_config(**knobs) -> RefConfig:
    cfg = RefConfig(**knobs)
    cfg.use_native = "never"
    return cfg


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_collapse_greedy_matches_reference(scene):
    data = _data(scene)
    got, want = _collapse_greedy(data), ref_collapse_greedy(data)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert np.array_equal(got[3], want[3])
    assert len(got[0]) > 1 and max(len(c) for c in got[0]) == 8


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_greedy_pack_matches_reference(scene):
    data = _data(scene)
    env = procedural_sky(64)
    ref = ref_pack_scene_wide(data, env, node_src="smem", collapse="greedy", isect="woop",
                              env_mode="dense", leaf_src="vmem")
    port = pack_scene_wide(data, env, Config(collapse="greedy"))
    sah = pack_scene_wide(data, env)
    assert port.n_wide == ref.n_wide != sah.n_wide
    assert port.stack_depth == ref.stack_depth and port.max_count == ref.max_count
    np.testing.assert_array_equal(port.orders.numpy(), np.asarray(ref.order_smem).reshape(-1, 8))
    ref_meta = np.asarray(ref.cmeta_smem).reshape(ref.n_wide, 8)
    tribase = np.asarray(ref.tribase_smem)
    meta = port.child_meta.numpy()
    for w in range(ref.n_wide):
        for k in range(8):
            r, p = int(ref_meta[w, k]), int(meta[w, k])
            if r == -1 or p == -1:
                assert r == p == -1
            elif (r >> COUNT_SHIFT) & 0x1F:  # a leaf: its count and first triangle
                assert p >> COUNT_SHIFT == (r >> COUNT_SHIFT) & 0x1F
                assert p & FIRST_MASK == tribase[r & FIRST_MASK]
            else:
                assert p == r


def _bench_rays(module, w=40, h=32):
    fov = np.deg2rad(40.0)
    cam = mat4.make_translation(0.0, 0.0, 2.6 / 2.0 / np.sin(fov / 2.0)).astype(np.float32)
    return module._camera_rays(w, h, fov, cam)


@pytest.mark.parametrize("collapse", ["sah", "greedy"])
@pytest.mark.parametrize("splits", ["object", "sbvh"])
def test_simulate_packet_walk_matches_reference(splits, collapse):
    data = _data("sphere", splits)
    P, D = _bench_rays(quality)
    assert all(np.array_equal(a, b) for a, b in zip((P, D), _bench_rays(ref_quality)))
    wt = quality.build_wide_tree(data, Config(collapse=collapse, splits=splits))
    ref_wt = ref_quality.build_wide_tree(data, _ref_config(collapse=collapse, splits=splits))
    assert wt.children == ref_wt.children and wt.wid_of == ref_wt.wid_of
    assert np.array_equal(wt.subtree_tris, ref_wt.subtree_tris)
    for any_hit in (False, True):
        st, ref_st = quality.WalkStats(), ref_quality.WalkStats()
        got = quality.simulate_packet_walk(data, wt, P, D, any_hit=any_hit, max_leaf_tests=10,
                                           stats=st)
        want = ref_quality.simulate_packet_walk(data, ref_wt, P, D, any_hit=any_hit,
                                                max_leaf_tests=10, stats=ref_st)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert dataclasses.asdict(st) == dataclasses.asdict(ref_st)
        assert got[4].any() and st.steps > 0


@pytest.mark.parametrize("collapse", ["sah", "greedy"])
@pytest.mark.parametrize("splits", ["object", "sbvh"])
def test_simulate_frame_matches_reference(splits, collapse):
    data = _data("sphere", splits)
    kw = dict(width=40, height=32, tile=512)
    got = quality.simulate_frame(data, config=Config(collapse=collapse, splits=splits), **kw)
    want = ref_quality.simulate_frame(data, config=_ref_config(collapse=collapse, splits=splits), **kw)
    assert [dataclasses.asdict(p) for p in got.phases] == [dataclasses.asdict(p) for p in want.phases]
    assert [p.name for p in got.phases] == ["bounce0", "shadow0", "bounce1", "shadow1", "bounce2",
                                            "shadow2"]
    assert got.total_steps_per_pkt == want.total_steps_per_pkt > 0


def test_greedy_frame_matches_sphere_golden_and_sah():
    data = _data("sphere")
    pos, _ = uv_sphere(lat=12, lon=16)  # the golden's scene: flat normals
    golden_data = get_shader_data(make_world(TriangleSet.from_arrays(pos)))
    params = default_frame_params()._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0, 0, 3.2)))
    statics = RenderStatics(width=64, height=64)
    greedy = Renderer(golden_data, procedural_sky(256), Config(collapse="greedy"), device="cpu")
    got = greedy.make_fn(statics)(params).numpy()
    err = np.abs(got - np.load(GOLDEN))
    assert err.mean() < 2e-3 and (err.max(axis=-1) <= 2e-2).mean() >= 0.99
    # the same leaves in another wide tree: the SAH tables' frame
    sah = Renderer(data, procedural_sky(256), device="cpu").make_fn(statics)(params)
    both = Renderer(data, procedural_sky(256), Config(collapse="greedy"), device="cpu")
    assert float((both.make_fn(statics)(params) - sah).abs().mean()) < 1e-5
