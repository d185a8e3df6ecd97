"""The scene builds the app can ask for, the port against the JAX package:
``make_sbvh`` (spatial splits, duplicated clipped references),
``_clip_tri_plane`` and ``optimize_bvh`` (reinsertion) give the same
nodes and reference order, byte for byte, through ``make_world`` on the
scenes of tests/test_sbvh.py (beams over a floor, a soup of long
diagonal triangles) and a small sphere; ``get_shader_data`` with R > T
references is the reference's after ``convert``; the plain walks of the
wide and binary tables over an SBVH tree find the reference traversal's
t, hit id (a reference index) and normal; a 64 x 64 frame of the fused
route on the SBVH and reinserted trees is the wavefront engine's within
the tolerance tests/test_torch_unfused.py states; ``validate_scene_data``
catches the four faults tests/test_validate.py plants, and the Renderer
runs it under ``Config.validate_scene``; the scene cache round-trips and
never reads the JAX package's files; ``scene_fingerprint`` is the
reference's and changes with each build knob."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models import fixtures as ref_fixtures
from shader_ray_tpu.models import sbvh as ref_sbvh
from shader_ray_tpu.models import validate as ref_validate
from shader_ray_tpu.models import world as ref_world
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.ops.render import RenderStatics as RefStatics
from shader_ray_tpu.ops.render import default_frame_params as ref_default_params
from shader_ray_tpu.ops.render import render_frame as ref_render_frame
from shader_ray_tpu.ops.scene import upload_scene
from shader_ray_tpu.ops.traversal import traverse
from shader_ray_tpu.utils import cache as ref_cache
from shader_ray_tpu.utils import mat4 as ref_mat4
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.convert import frame_params_from_numpy, scene_data_from_numpy
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.models import sbvh, validate, world
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.ops.pack import pack_scene
from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide
from shader_ray_tpu_torch.ops.render import RenderStatics
from shader_ray_tpu_torch.ops.trace_kernel import INFINITELY_FAR, trace
from shader_ray_tpu_torch.utils import cache
from test_sbvh import _beams_and_floor, _long_diagonal_soup
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCENES = {
    "beams": lambda: (_beams_and_floor(), None),
    "soup": lambda: (_long_diagonal_soup(), None),
    "sphere": lambda: ref_fixtures.uv_sphere(lat=10, lon=14),
}
BUILDS = {"sbvh": dict(splits="sbvh"), "sbvh-reinsert": dict(splits="sbvh", bvh_opt="reinsert"),
          "reinsert": dict(bvh_opt="reinsert")}
SCENE_FIELDS = ("tri_positions", "tri_normals", "node_boxes", "node_objects", "node_children",
                "hitmiss", "tree_root", "triangle_count", "group_count")


def _ref_config(**knobs) -> RefConfig:
    cfg = RefConfig(**knobs)
    cfg.use_native = "never"
    cfg.scene_cache = False
    return cfg


@functools.cache
def _worlds(scene: str, build: str):
    """(port World, reference World) of one scene and build."""
    pos, nrm = SCENES[scene]()
    knobs = BUILDS.get(build, {})
    return (world.make_world(TriangleSet.from_arrays(pos, nrm), Config(**knobs)),
            ref_world.make_world(RefTriangleSet.from_arrays(pos, nrm), _ref_config(**knobs)))


@functools.cache
def _data(scene: str, build: str):
    """(port SceneData, reference SceneData) of one scene and build."""
    got, ref = _worlds(scene, build)
    return world.get_shader_data(got), ref_world.get_shader_data(ref, _ref_config(**BUILDS[build]))


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_builds_equal_the_references(scene, build):
    got, ref = (w.bvh for w in _worlds(scene, build))
    assert got.root == ref.root and len(got.nodes) == len(ref.nodes)
    assert got.order.dtype == ref.order.dtype and np.array_equal(got.order, ref.order)
    for i, (a, b) in enumerate(zip(got.nodes, ref.nodes)):
        assert a.boxmin.tobytes() == b.boxmin.tobytes() and a.boxmax.tobytes() == b.boxmax.tobytes(), i
        assert (a.negative, a.positive, a.start, a.count, a.axis) == \
            (b.negative, b.positive, b.start, b.count, b.axis), i
    if build.startswith("sbvh"):
        assert dataclasses.asdict(got.stats) == vars(ref.stats)
    T = SCENES[scene]()[0].shape[0]
    # only the beams take spatial splits (test_sbvh.py): R > T there
    assert (len(got.order) > T) == (scene == "beams" and build.startswith("sbvh"))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_clip_tri_plane_equals_the_references(axis):
    rng = np.random.default_rng(axis)
    V = rng.uniform(-1.0, 1.0, size=(200, 3, 3)).astype(np.float32)
    V[:20, 0, axis] = 0.25  # a vertex on the plane
    V[20:40, :2, axis] = 0.25  # an edge on it
    for a, b in zip(sbvh._clip_tri_plane(V, axis, 0.25), ref_sbvh._clip_tri_plane(V, axis, 0.25)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    lmin, lmax, rmin, rmax = sbvh._clip_tri_plane(V, axis, 0.25)
    assert (lmax[:, axis] <= 0.25).all() and (rmin[:, axis] >= 0.25).all()


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_shader_data_with_duplicated_references_equals_the_references(build):
    got, ref = _data("beams", build)
    conv = scene_data_from_numpy(vars(ref))
    for name in SCENE_FIELDS:
        a, b = getattr(got, name), getattr(conv, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
        else:
            assert a == b, name
    T = _beams_and_floor().shape[0]
    assert (got.triangle_count > T) == build.startswith("sbvh")
    assert got.tri_positions.shape == (got.triangle_count, 9)
    validate.validate_scene_data(got)


def _rays(n: int = 1024, seed: int = 11):
    rng = np.random.default_rng(seed)
    P = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    D = rng.normal(size=(n, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    P[: n // 2] = rng.uniform(-1, 1, size=(n // 2, 3)) * [1, 1, 0] + [0, 0, 2]  # down at the floor
    D[: n // 2] = D[: n // 2] * 0.3 + [0, 0, -1]
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    return P, D


@pytest.mark.parametrize("kernel", ["wide", "binary"])
def test_plain_walks_over_an_sbvh_tree_match_the_reference_traversal(kernel):
    """The SBVH beams tree (R > T): t, hit flags and the interpolated
    normal as the reference's traversal; ids equal (binary: the same walk
    and Moller-Trumbore) or tied (wide: the Woop test may take the other
    copy's t to the last bit); a hit id is a reference whose triangle
    holds the hit point."""
    got_data, ref = _data("beams", "sbvh")
    P, D = _rays()
    want = traverse(upload_scene(ref, np.ones((1, 1, 3), np.float32)), jnp.asarray(P),
                    jnp.asarray(D), max_bvh_iterations=100000)
    pack = pack_scene_wide if kernel == "wide" else pack_scene
    hit = trace(pack(got_data, np.ones((1, 2, 3), np.float32)), torch.from_numpy(P),
                torch.from_numpy(D))
    t, which, t_ref, which_ref = hit.t.numpy(), hit.which.numpy(), np.asarray(want.t), np.asarray(want.which)
    h = t < INFINITELY_FAR
    np.testing.assert_array_equal(h, t_ref < INFINITELY_FAR)
    assert h.mean() > 0.3 and not hit.bad.any()
    order = _worlds("beams", "sbvh")[0].bvh.order
    split = np.bincount(order)[order] > 1  # references of triangles listed more than once
    assert split[which[h]].sum() >= 10
    np.testing.assert_allclose(t[h], t_ref[h], rtol=1e-5, atol=1e-6)
    if kernel == "binary":
        np.testing.assert_array_equal(which[h], which_ref[h])
    else:
        differ = h & (which != which_ref)
        assert (np.abs(t[differ] - t_ref[differ]) < 1e-6).all() and differ.mean() < 0.02
    assert (which[h] < got_data.triangle_count).all() and (which[~h] == -1).all()
    tri_n = ref.tri_normals[np.maximum(which_ref, 0)]
    u, v = np.asarray(want.u)[:, None], np.asarray(want.v)[:, None]
    n_ref = tri_n[:, 0:3] * (1 - u - v) + tri_n[:, 3:6] * u + tri_n[:, 6:9] * v
    np.testing.assert_allclose(hit.normal.numpy()[h], n_ref[h], rtol=1e-4, atol=1e-4)
    # the hit point lies in the plane of the referenced triangle
    tri = got_data.tri_positions[which[h]].reshape(-1, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    X = P[h] + t[h, None] * D[h]
    assert np.abs(((X - tri[:, 0]) * n).sum(1)).max() < 1e-4


def _assert_frame_close(got, want):
    """tests/test_torch_unfused.py's tolerance against the wavefront engine."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.mean() < 2e-3, err.mean()
    assert (err.max(axis=-1) <= 2e-2).mean() >= 0.99, (err.max(axis=-1) > 2e-2).mean()


@pytest.mark.parametrize("build", ["sbvh", "reinsert"])
def test_fused_frame_over_sbvh_and_reinserted_trees_matches_the_wavefront_engine(build):
    """The beams over the floor from above at 64 x 64 (shadows of the
    beams, the sky in the floor's reflection): the port's fused route
    (the frame kernel's plain version) on the built tree against the
    reference's wavefront engine on its own build of the same tree."""
    got_data, ref = _data("beams", build)
    env = ref_fixtures.procedural_sky(128)
    jp = ref_default_params()._replace(
        camera_matrix=jnp.asarray(ref_mat4.make_translation(0.0, 0.0, 3.0)),
        light_dir=jnp.asarray(np.array([0.36, 0.48, 0.8], np.float32)),
        specular_color=jnp.asarray(np.array([0.3, 0.3, 0.3], np.float32)),
    )
    statics = RefStatics(width=64, height=64, tile_size=64 * 64)
    want = np.asarray(jax.jit(lambda s, p: ref_render_frame(s, p, statics))(upload_scene(ref, env), jp))
    r = Renderer(got_data, env, device="cpu")
    assert r.fused
    got = r.make_fn(RenderStatics(width=64, height=64))(
        frame_params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}))
    assert got.shape == (64, 64, 3) and want.std() > 0.05
    _assert_frame_close(got.numpy(), want)


FAULTS = ("hitmiss", "leaf-overrun", "inverted-box", "orphan")


def _corrupt(data, fault: str):
    """tests/test_validate.py's four faults, planted in ``data``."""
    if fault == "hitmiss":
        hm = data.hitmiss.copy()
        hm[3, 1, 0] = data.group_count + 7
        return dataclasses.replace(data, hitmiss=hm)
    if fault == "leaf-overrun":
        obj = data.node_objects.copy()
        obj[np.nonzero(obj[:, 1] > 0)[0][0], 0] = data.triangle_count - 1
        return dataclasses.replace(data, node_objects=obj)
    if fault == "inverted-box":
        boxes = data.node_boxes.copy()
        boxes[0, 0] = boxes[0, 3] + 1.0
        return dataclasses.replace(data, node_boxes=boxes)
    ch = data.node_children.copy()
    internal = np.nonzero(data.node_objects[:, 1] == 0)[0]
    victim = internal[internal != data.tree_root][0]
    ch[victim, 0] = ch[victim, 1]  # a duplicate child: some node orphaned
    return dataclasses.replace(data, node_children=ch)


@pytest.mark.parametrize("fault", FAULTS)
def test_validation_catches_the_references_faults(fault):
    got, ref = _data("sphere", "sbvh")
    validate.validate_scene_data(got)
    with pytest.raises(ref_validate.SceneValidationError) as want:
        ref_validate.validate_scene_data(_corrupt(ref, fault))
    with pytest.raises(validate.SceneValidationError) as err:
        validate.validate_scene_data(_corrupt(got, fault))
    assert str(err.value) == str(want.value)
    env = np.ones((1, 2, 3), np.float32)
    with pytest.raises(validate.SceneValidationError):
        Renderer(_corrupt(got, fault), env, Config(validate_scene=True), device="cpu")
    Renderer(got, env, Config(validate_scene=True), device="cpu")


def test_scene_cache_round_trips_apart_from_the_references(tmp_path, monkeypatch):
    monkeypatch.setenv("SRT_CACHE_DIR", str(tmp_path))
    got, ref = _data("beams", "sbvh")
    key = "k" * 24
    assert cache.load_scene_data(key) is None
    ref_cache.save_scene_data(key, ref)  # the JAX package's file, same key, same directory
    assert cache.load_scene_data(key) is None
    cache.save_scene_data(key, got)
    back = cache.load_scene_data(key)
    for name in SCENE_FIELDS:
        a, b = getattr(back, name), getattr(got, name)
        assert np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype, name
    assert ref_cache.load_scene_data(key).tri_colors.shape == ref.tri_colors.shape  # still its own
    built = []
    assert cache.cached_scene_data(key, lambda: built.append(1)).triangle_count == got.triangle_count
    assert cache.cached_scene_data("m" * 24, lambda: got) is got and built == []
    assert cache.load_scene_data("m" * 24) is not None
    path = cache._path(key)
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 torn")
    assert cache.load_scene_data(key) is None


def test_scene_fingerprint_is_the_references_and_changes_with_each_knob(tmp_path):
    path = tmp_path / "m.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    knobs = [{}, dict(bvh_leaf_max=4), dict(bvh_max_depth=12), dict(sah_ctrav=2.0),
             dict(sah_cisec=3.0), dict(colors_are_linear=True), dict(geometry_scale=2.0),
             dict(splits="sbvh"), dict(bvh_opt="reinsert"), dict(splits="sbvh", bvh_opt="reinsert")]
    keys = [world.scene_fingerprint(str(path), Config(**k)) for k in knobs]
    assert keys == [ref_world.scene_fingerprint(str(path), _ref_config(**k)) for k in knobs]
    assert len(set(keys)) == len(knobs)
    assert world.scene_fingerprint(str(path), Config(env_aniso=2, min_contrib=0.1)) == keys[0]
    path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 1\nf 1 2 3\n")
    assert world.scene_fingerprint(str(path)) != keys[0]
