"""The port's native scene builder (shader_ray_tpu_torch/native.py, its
own g++ build of csrc/host/libscene.cpp) against the port's numpy build
and the JAX package's: ``make_world`` with ``use_native="require"``
gives the ``SceneData`` of ``use_native="never"`` and of the reference's
numpy ``get_shader_data`` on every array, byte for byte, for random,
clustered, degenerate (stacked), knob-varied, sphere, bunny-class and
empty scenes (the scenes of tests/test_native.py); the native SBVH gives
``make_sbvh`` + ``flatten_bvh``'s tree and reference order bit for bit
(beams over a floor, a soup of long triangles, knot.obj and a small
atrium of the benchmark's) and is ``splits="sbvh"``'s route unless
``use_native="never"``; the native OBJ,
trisrc and Radiance HDR readers equal the port's Python readers;
the native 8-wide SAH collapse gives the numpy collapse's wide tree, and
``pack_scene_wide`` the same tables on either route (the greedy collapse
stays numpy); ``use_native="require"`` raises when the library cannot be
built, from the build and from the pack, ``auto`` then falls back to
numpy, and ``never`` builds nothing."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.models.world import get_shader_data as ref_get_shader_data
from shader_ray_tpu.models.world import make_world as ref_make_world
from shader_ray_tpu_torch import native
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models import background, obj, trisrc
from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky, uv_sphere
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import SceneData, get_shader_data, load_world, make_world
from shader_ray_tpu_torch.utils.hdr import write_hdr
from test_sbvh import _beams_and_floor, _long_diagonal_soup
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ASSETS = pathlib.Path(__file__).resolve().parent / "assets"
ARRAYS = ("tri_positions", "tri_normals", "node_boxes", "node_objects", "node_children", "hitmiss")
INTS = ("tree_root", "triangle_count", "group_count")


def _random():
    return np.random.default_rng(0).normal(size=(500, 3, 3)).astype(np.float32), None


def _clustered():
    """Clustered geometry: the large-leaf and one-side paths."""
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(20, 1, 1, 3)) * 10.0
    return (centers + rng.normal(size=(20, 40, 3, 3)) * 0.1).reshape(-1, 3, 3).astype(np.float32), None


def _degenerate():
    """Identical barycenters (stacked triangles): no split, and past the
    leaf cap."""
    tri = np.random.default_rng(2).normal(size=(1, 3, 3)).astype(np.float32)
    return np.repeat(tri, 50, axis=0), None


SCENES = {
    "random": (_random, {}),
    "sphere": (lambda: uv_sphere(lat=16, lon=24), {}),
    "clustered": (_clustered, {}),
    "degenerate": (_degenerate, {}),
    "knobs": (lambda: uv_sphere(lat=10, lon=14),
              dict(bvh_leaf_max=4, bvh_max_depth=6, sah_cisec=2.0, sah_ctrav=1.5)),
    "bunny_class": (lambda: bunny_class_scene(20000), {}),
    "empty": (lambda: (np.zeros((0, 3, 3), np.float32), None), {}),
}


def _ref_config(**knobs) -> RefConfig:
    cfg = RefConfig(**knobs)
    cfg.use_native = "never"
    return cfg


def _assert_same(got: SceneData, want, what: str):
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {name}"
        assert a.tobytes() == b.tobytes(), f"{what}: {name}"
    for name in INTS:
        assert getattr(got, name) == getattr(want, name), f"{what}: {name}"


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_native_build_equals_numpy_and_reference(scene):
    make, knobs = SCENES[scene]
    pos, nrm = make()
    ts = TriangleSet.from_arrays(pos, nrm)
    w_native = make_world(ts, Config(use_native="require", **knobs))
    w_numpy = make_world(ts, Config(use_native="never", **knobs))
    assert w_native.bvh is None and w_native.flat is not None  # the native path ran
    assert w_numpy.flat is None and w_numpy.bvh is not None
    assert w_native.tri_order.tobytes() == w_numpy.tri_order.tobytes()
    native_data = get_shader_data(w_native)
    _assert_same(native_data, get_shader_data(w_numpy), f"{scene} native vs numpy")
    ref_cfg = _ref_config(**knobs)
    ref = ref_get_shader_data(ref_make_world(RefTriangleSet.from_arrays(pos, nrm), ref_cfg), ref_cfg)
    if scene == "degenerate":
        _assert_cap_split(native_data, ref, Config(**knobs).max_leaf_tests)
    else:
        _assert_same(native_data, ref, f"{scene} native vs the reference")


def _assert_cap_split(got: SceneData, ref, cap: int):
    """The leaf cap split (models/bvh.py ``_cap_split``): where no split
    divides a node of more than ``cap`` triangles, the reference makes the
    leaf, of which the kernels test ``cap``; the port splits it at the
    median until every leaf holds at most ``cap``, over the same triangles
    each once."""
    def leaf_counts(d):
        return d.node_objects[d.node_children[:, 0] < 0, 1]

    assert leaf_counts(ref).max() > cap >= leaf_counts(got).max()
    assert leaf_counts(got).sum() == got.triangle_count == ref.triangle_count
    rows = np.sort(got.tri_positions.view(np.uint32), axis=0)
    assert rows.tobytes() == np.sort(ref.tri_positions.view(np.uint32), axis=0).tobytes()


def test_native_leaf_count_and_flat_match_the_numpy_tree():
    from shader_ray_tpu_torch.models.bvh import make_bvh
    from shader_ray_tpu_torch.models.flatten import flatten_bvh

    ts = TriangleSet.from_arrays(*uv_sphere(lat=12, lon=16))
    bvh = make_bvh(ts.tri_boxmin, ts.tri_boxmax, ts.barycenters, Config())
    flat, order, leaves = native.build_flat_bvh(ts.tri_boxmin, ts.tri_boxmax, ts.barycenters)
    want = flatten_bvh(bvh)
    assert leaves == sum(n.is_leaf for n in bvh.nodes) and flat.root == want.root
    for f in dataclasses.fields(want):
        assert np.array_equal(getattr(flat, f.name), getattr(want, f.name)), f.name
    assert np.array_equal(order, bvh.order)


def _atrium(target: int) -> np.ndarray:
    """The benchmark's atrium (portbench/scenes/atrium.py) at ``target``
    triangles, in its configuration's layout."""
    import json

    from portbench import spec

    with open(spec.ROOT / "portbench" / "configs" / "sponza262k.json") as f:
        scene = dict(json.load(f)["scene"], target_tris=target)
    return spec.module("scenes", "atrium").generate(scene)


def _knot() -> np.ndarray:
    ts = obj.parse_obj(str(ASSETS / "knot.obj"), config=Config(use_native="never"))
    return ts.positions[ts.indices]


# (triangle positions, whether spatial splits duplicate references)
SBVH_SCENES = {
    "beams": (lambda: _beams_and_floor(), True),
    "soup": (lambda: _long_diagonal_soup(), False),
    "knot": (_knot, True),
    "atrium": (lambda: _atrium(2000), True),
    "empty": (lambda: np.zeros((0, 3, 3), np.float32), False),
}


@pytest.mark.parametrize("scene", sorted(SBVH_SCENES))
def test_native_sbvh_equals_numpy_make_sbvh(scene):
    """``native.build_flat_sbvh`` is ``make_sbvh`` + ``flatten_bvh`` bit for
    bit: every FlatBVH field, the reference order, the leaf count and the
    spatial splits, and ``make_world`` routes ``splits="sbvh"`` to it
    under ``require`` with the same ``get_shader_data`` tables as under
    ``never``."""
    from shader_ray_tpu_torch.models.flatten import flatten_bvh

    make, duplicates = SBVH_SCENES[scene]
    verts = make()
    ts = TriangleSet.from_arrays(verts)
    assert np.array_equal(ts.positions[ts.indices], verts)
    w_numpy = make_world(ts, Config(splits="sbvh", use_native="never"))   # make_sbvh
    w_native = make_world(ts, Config(splits="sbvh", use_native="require"))
    cfg, bvh = Config(), w_numpy.bvh
    want = flatten_bvh(bvh)
    flat, order, leaves, splits = native.build_flat_sbvh(
        verts, leaf_max=cfg.bvh_leaf_max, max_depth=cfg.bvh_max_depth, ctrav=cfg.sah_ctrav,
        cisec=cfg.sah_cisec)
    for f in dataclasses.fields(want):
        a, b = getattr(flat, f.name), getattr(want, f.name)
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b), f.name
    assert order.dtype == bvh.order.dtype and order.tobytes() == bvh.order.tobytes()
    assert leaves == sum(n.is_leaf for n in bvh.nodes) and splits == w_numpy.counts.spatial_splits
    assert (len(order) > len(verts)) == duplicates == (splits > 0)
    assert w_native.bvh is None and w_native.counts.route == "sbvh-native"
    assert w_native.counts == dataclasses.replace(w_numpy.counts, route="sbvh-native")
    _assert_same(get_shader_data(w_native), get_shader_data(w_numpy), f"{scene} native vs numpy")


def _star(n: int = 60) -> np.ndarray:
    """``n`` long thin triangles in the plane z = 0, each a spoke at its own
    angle with its barycenter at the origin: no object split divides
    them, so the reference's object build makes one leaf of all ``n``."""
    th = np.pi * np.arange(n) / n
    u = np.array([[1.0, 0.0], [-0.5, 0.06], [-0.5, -0.06]])
    rot = np.stack([np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], -2)
    xy = np.einsum("nij,kj->nki", rot, u)
    return np.concatenate([xy, np.zeros((n, 3, 1))], -1).astype(np.float32)


@pytest.mark.parametrize("splits,use_native", [("object", "never"), ("object", "require"),
                                               ("sbvh", "never"), ("sbvh", "require")])
def test_an_over_cap_scene_renders_as_the_brute_force_oracle(splits, use_native):
    """Rays straight down onto the star hit what the brute-force oracle
    hits, on every route: the builds split a node that no split divides
    past ``max_leaf_tests`` (the leaf cap split), where the reference's
    build leaves a leaf of which the kernels test only the first 10 of 60
    (the pack then warns)."""
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide
    from shader_ray_tpu_torch.ops.reference import intersect_brute
    from shader_ray_tpu_torch.ops.trace_kernel import INFINITELY_FAR, trace

    tri = _star()
    cfg = Config(splits=splits, use_native=use_native)
    ref_cfg = _ref_config()
    ref = ref_get_shader_data(ref_make_world(RefTriangleSet.from_arrays(tri), ref_cfg), ref_cfg)
    assert ref.node_objects[:, 1].max() == len(tri)        # the reference's one leaf
    data = get_shader_data(make_world(TriangleSet.from_arrays(tri), cfg))
    assert data.node_objects[data.node_children[:, 0] < 0, 1].max() <= cfg.max_leaf_tests
    g = np.linspace(-0.95, 0.95, 48, dtype=np.float32)
    P = np.stack(np.meshgrid(g, g, [1.0], indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    D = np.broadcast_to(np.float32([0.0, 0.0, -1.0]), P.shape).copy()
    got = trace(pack_scene_wide(data, procedural_sky(8), cfg), torch.from_numpy(P), torch.from_numpy(D))
    t_ref = intersect_brute(tri, P, D)[0].numpy()
    hit = got.t.numpy() < INFINITELY_FAR
    np.testing.assert_array_equal(hit, t_ref < INFINITELY_FAR)
    assert 0.2 < hit.mean() < 0.8
    np.testing.assert_allclose(got.t.numpy()[hit], t_ref[hit], atol=1e-6)


@pytest.mark.parametrize("splits", ["object", "sbvh"])
def test_native_builds_of_the_full_atrium_keep_leaves_within_the_leaf_cap(splits):
    """Over the benchmark's 262,267-triangle atrium both native builds would
    make leaves past the kernels' ``max_leaf_tests`` (the object split
    hundreds, of up to 1,216 references; the SBVH a few, where a spatial
    split's clips leave one child every reference), whose references
    past the cap are never tested.  The leaf cap split keeps every leaf
    within the cap, over every reference once a leaf slot."""
    verts = _atrium(262267)
    ts = TriangleSet.from_arrays(verts)
    cfg = Config()

    def leaf_counts(cap):
        if splits == "object":
            flat, order, leaves = native.build_flat_bvh(ts.tri_boxmin, ts.tri_boxmax, ts.barycenters,
                                                        leaf_cap=cap)
        else:
            flat, order, leaves, _ = native.build_flat_sbvh(ts.positions[ts.indices], leaf_cap=cap)
        is_leaf = flat.children[:, 0] < 0
        assert leaves == is_leaf.sum() and flat.count[is_leaf].sum() == len(order)
        return flat.count[is_leaf]

    assert leaf_counts(2**30).max() > cfg.max_leaf_tests
    assert leaf_counts(cfg.max_leaf_tests).max() <= cfg.max_leaf_tests


def test_native_build_skips_sbvh_and_reinsert():
    """``splits="sbvh"`` takes the native build under ``auto`` and
    ``require`` and the numpy one under ``never``; reinsertion (which
    needs the node list) builds in Python after either split, even under
    ``require``, as in the reference."""
    ts = TriangleSet.from_arrays(*uv_sphere(lat=6, lon=8))
    for use_native, route in (("auto", "sbvh-native"), ("require", "sbvh-native"), ("never", "sbvh")):
        w = make_world(ts, Config(splits="sbvh", use_native=use_native))
        assert w.counts.route == route and (w.flat is None) == (route == "sbvh")
        assert (w.bvh is None) == (route == "sbvh-native")
    for knobs in (dict(splits="sbvh", bvh_opt="reinsert"), dict(bvh_opt="reinsert")):
        w = make_world(ts, Config(use_native="require", **knobs))
        assert w.flat is None and w.bvh is not None and w.counts.route == knobs.get("splits", "object")


def _one_leaf():
    return np.random.default_rng(3).normal(size=(3, 3, 3)).astype(np.float32), None


# the native builds' scenes, SBVH tables with R > T and a one-leaf tree
COLLAPSE_SCENES = sorted(SCENES) + ["sbvh-atrium", "sbvh-beams", "one_leaf"]


def _collapse_scene(scene: str, **knobs) -> SceneData:
    if scene.startswith("sbvh-"):
        verts = SBVH_SCENES[scene[5:]][0]()
        data = get_shader_data(make_world(TriangleSet.from_arrays(verts), Config(splits="sbvh", **knobs)))
        assert data.triangle_count > len(verts)  # spatial splits duplicated references
        return data
    make, build_knobs = SCENES.get(scene, (_one_leaf, {}))
    return get_shader_data(make_world(TriangleSet.from_arrays(*make()), Config(**build_knobs, **knobs)))


@pytest.mark.parametrize("scene", COLLAPSE_SCENES)
def test_native_collapse_equals_numpy_collapse_sah(scene):
    """``native.collapse_sah`` gives ``_collapse_sah``'s wide tree: each wide
    node's child slots in the same order (then -1), its depth, and each
    binary node's wide id."""
    from shader_ray_tpu_torch.ops.pack_wide import _collapse_sah

    data = _collapse_scene(scene)
    wide_children, wid_of, depth_of, _ = _collapse_sah(data)
    slots, depth, wid = native.collapse_sah(data)
    assert slots.dtype == depth.dtype == wid.dtype == np.int32
    assert slots.tolist() == [fr + [-1] * (8 - len(fr)) for fr in wide_children]
    assert depth.tolist() == depth_of
    assert wid.shape == (data.group_count,)
    assert {b: w for b, w in enumerate(wid.tolist()) if w >= 0} == wid_of
    if scene == "one_leaf":
        assert data.group_count == 1 and wide_children == [[data.tree_root]]


def _broken(data: SceneData, how: str) -> SceneData:
    children = data.node_children.copy()
    inner = np.flatnonzero(children[:, 0] >= 0)
    if how == "root":
        return dataclasses.replace(data, tree_root=data.group_count)
    if how == "past_the_end":
        children[inner[-1], 1] = data.group_count
    elif how == "one_child":
        children[inner[-1], 1] = -1
    elif how == "cycle":  # a branch's child is the root again
        children[inner[inner != data.tree_root][0], 0] = data.tree_root
    return dataclasses.replace(data, node_children=children)


@pytest.mark.parametrize("how,error", [("past_the_end", ValueError), ("one_child", ValueError),
                                       ("root", RuntimeError), ("cycle", RuntimeError)])
def test_native_collapse_refuses_tables_that_are_not_a_tree(how, error):
    """Node tables that disagree with ``group_count``, or do not form a tree
    from the root, raise before or from the native collapse, not a crash."""
    with pytest.raises(error, match="native collapse"):
        native.collapse_sah(_broken(_collapse_scene("sphere"), how))


def _loop_nodes(data: SceneData, cfg: Config) -> np.ndarray:
    """The node table as a loop over every child of the collapse's lists
    fills it: boxes, meta and the octant orders of f64 centers."""
    from shader_ray_tpu_torch.ops.pack_wide import COLLAPSES, COUNT_SHIFT, capped_counts

    wide_children, wid_of, _, is_leaf = COLLAPSES[cfg.collapse](data)
    counts = capped_counts(data, cfg)
    nodes = np.zeros((len(wide_children), 8, 8), np.float32)
    bits = nodes.view(np.int32)
    bits[..., 3] = -1
    centers = np.full((len(wide_children), 8, 3), np.inf)
    for w, fr in enumerate(wide_children):
        for k, b in enumerate(fr):
            lo, hi = data.node_boxes[b, 0:3], data.node_boxes[b, 3:6]
            nodes[w, k, 0:3], nodes[w, k, 4:7] = lo, hi
            centers[w, k] = 0.5 * (lo.astype(np.float64) + hi.astype(np.float64))
            bits[w, k, 3] = ((int(counts[b]) << COUNT_SHIFT) | int(data.node_objects[b, 0])
                             if is_leaf[b] else wid_of[b])
    for w in range(len(wide_children)):
        for o in range(8):
            d = [1.0 if (o >> a) & 1 else -1.0 for a in range(3)]
            keys = [sum(float(c) * s for c, s in zip(centers[w, k], d))
                    if np.isfinite(centers[w, k, 0]) else np.inf for k in range(8)]
            bits[w, o, 7] = sum(k << (3 * p) for p, k in enumerate(sorted(range(8), key=keys.__getitem__)))
    return nodes


@pytest.mark.parametrize("isect", ["woop", "mt"])
@pytest.mark.parametrize("scene", ["bunny_class", "sbvh-atrium", "one_leaf", "empty"])
def test_pack_is_byte_equal_under_the_native_and_numpy_collapse(scene, isect):
    """``pack_scene_wide`` packs the same tables byte for byte whether the
    SAH collapse runs natively (``require``) or in numpy (``never``), and
    its node table is the per-child loop's over the collapse's lists."""
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide

    data = _collapse_scene(scene)
    env = procedural_sky(8)
    got, want = (pack_scene_wide(data, env, Config(leaf_isect=isect, use_native=use_native))
                 for use_native in ("require", "never"))
    for name in ("nodes", "leaves", "normals"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.numpy().tobytes() == b.numpy().tobytes(), name
    for name in ("n_wide", "stack_depth", "max_count", "isect"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.nodes.numpy().tobytes() == _loop_nodes(data, Config()).tobytes()


def test_greedy_collapse_never_takes_the_native_route(monkeypatch):
    """``collapse="greedy"`` stays on the numpy ``_collapse_greedy`` under
    every ``use_native``, with the per-child loop's node table."""
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide

    def refused(data):
        raise AssertionError("the greedy collapse took the native route")

    data = _collapse_scene("bunny_class")
    monkeypatch.setattr(native, "collapse_sah", refused)
    packs = [pack_scene_wide(data, procedural_sky(8), Config(collapse="greedy", use_native=u))
             for u in ("require", "auto", "never")]
    want = _loop_nodes(data, Config(collapse="greedy")).tobytes()
    assert all(p.nodes.numpy().tobytes() == want for p in packs)
    assert len({p.stack_depth for p in packs}) == 1


def _write_obj(path, with_normals: bool):
    verts = [(-0.5, -0.5, 0), (0.5, -0.5, 0), (0.5, 0.5, 0.2), (-0.5, 0.5, 0.2), (0.0, 0.0, 1.0)]
    lines = ["o thing"] + [f"v {x} {y} {z}" for x, y, z in verts]
    if with_normals:
        lines += ["vn 0 0 1"] * len(verts) + ["f 1//1 2//2 3//3 4//4", "f 1//1 2//2 5//5"]
    else:
        lines += ["f 1 2 3 4", "f 1 2 5", "f -3 -2 -1"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _assert_same_sets(got: TriangleSet, want: TriangleSet):
    for name in ("positions", "normals", "colors", "indices"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("with_normals", [True, False])
def test_native_obj_reader_equals_python(tmp_path, with_normals):
    path = str(tmp_path / "t.obj")
    _write_obj(path, with_normals)
    got = obj.parse_obj(path, config=Config(use_native="require"))
    assert got.triangle_count == (3 if with_normals else 4)
    _assert_same_sets(got, obj.parse_obj(path, config=Config(use_native="never")))


def test_native_obj_reader_on_the_knot_asset():
    import os

    knot = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "knot.obj")
    _assert_same_sets(obj.parse_obj(knot, config=Config(use_native="require")),
                      obj.parse_obj(knot, config=Config(use_native="never")))
    native_world = load_world(knot, Config(use_native="require"), verbose=False)
    numpy_world = load_world(knot, Config(use_native="never"), verbose=False)
    _assert_same(get_shader_data(native_world), get_shader_data(numpy_world), "knot.obj")


@pytest.mark.parametrize("knobs", [{}, {"colors_are_linear": True, "geometry_scale": 2.5}])
def test_native_trisrc_reader_equals_python(tmp_path, knobs):
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(17, 3, 3)).astype(np.float32)
    col = rng.uniform(0.1, 1.0, size=(17, 3, 3)).astype(np.float32)
    path = str(tmp_path / "t.trisrc")
    trisrc.write_trisrc(path, pos, tri_color=col)
    got = trisrc.parse_trisrc(path, Config(use_native="require", **knobs))
    want = trisrc.parse_trisrc(path, Config(use_native="never", **knobs))
    assert got.triangle_count == want.triangle_count == 17
    _assert_same_sets(got, want)  # the gamma decode pow(c, 2.63) too


def test_native_readers_reject_bad_files(tmp_path):
    bad = tmp_path / "bad.trisrc"
    bad.write_text('"*" default 1 1 1 1 10\n1 2 3\n')  # a truncated vertex block
    with pytest.raises(ValueError):
        trisrc.parse_trisrc(str(bad), Config(use_native="require"))
    with pytest.raises(FileNotFoundError):
        obj.parse_obj(str(tmp_path / "none.obj"), config=Config(use_native="require"))
    notes = tmp_path / "notes.hdr"
    notes.write_bytes(b"not a radiance file\n")
    with pytest.raises(ValueError, match="not a Radiance HDR"):
        background.read_hdr(str(notes), config=Config(use_native="require"))


def test_native_hdr_reader_equals_python(tmp_path):
    img = procedural_sky(64).astype(np.float32)
    path = str(tmp_path / "sky.hdr")
    write_hdr(path, img)
    got = background.read_hdr(path, config=Config(use_native="require"))
    want = background.read_hdr(path, config=Config(use_native="never"))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(background.load_background(path, config=Config(use_native="require")), want)


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """No g++ and an empty build directory: the library cannot be built."""
    def missing():
        raise RuntimeError("g++ not found: the native scene builder builds with g++")

    monkeypatch.setattr(native, "_compiler", missing)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._load.cache_clear()
    yield
    native._load.cache_clear()


def test_require_without_a_compiler_raises(no_compiler, tmp_path):
    assert not native.available()
    ts = TriangleSet.from_arrays(*uv_sphere(lat=4, lon=6))
    with pytest.raises(RuntimeError, match="use_native=require.*g\\+\\+ not found"):
        make_world(ts, Config(use_native="require"))
    path = str(tmp_path / "t.obj")
    _write_obj(path, True)
    with pytest.raises(RuntimeError, match="use_native=require"):
        obj.parse_obj(path, config=Config(use_native="require"))
    # auto falls back to numpy, the same tables
    w = make_world(ts, Config(use_native="auto"))
    assert w.flat is None and w.bvh is not None
    _assert_same(get_shader_data(w), get_shader_data(make_world(ts, Config(use_native="never"))),
                 "auto without a compiler")
    assert not (tmp_path / "build").exists()


def test_require_without_a_compiler_raises_from_the_pack(no_compiler):
    """The pack's SAH collapse under ``require`` raises as the build does;
    ``auto`` then takes the numpy collapse, and the greedy collapse never
    asks for the library."""
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide

    data = get_shader_data(make_world(TriangleSet.from_arrays(*uv_sphere(lat=4, lon=6)),
                                      Config(use_native="never")))
    env = procedural_sky(8)
    with pytest.raises(RuntimeError, match="use_native=require.*g\\+\\+ not found"):
        pack_scene_wide(data, env, Config(use_native="require"))
    auto, never = (pack_scene_wide(data, env, Config(use_native=u)) for u in ("auto", "never"))
    assert auto.nodes.numpy().tobytes() == never.nodes.numpy().tobytes()
    assert pack_scene_wide(data, env, Config(collapse="greedy", use_native="require")).n_wide > 0


def test_never_builds_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._load.cache_clear()
    try:
        ts = TriangleSet.from_arrays(*uv_sphere(lat=4, lon=6))
        assert make_world(ts, Config(use_native="never")).bvh is not None
        assert not (tmp_path / "build").exists()
    finally:
        native._load.cache_clear()


def test_build_lands_in_the_port_build_directory():
    so = native.build()
    assert "shader_ray_tpu_torch/build/libscene-" in so.replace("\\", "/")
    assert native._path().name == so.rsplit("/", 1)[-1]
