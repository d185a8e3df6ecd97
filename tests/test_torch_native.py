"""The port's native scene builder (shader_ray_tpu_torch/native.py, its
own g++ build of csrc/host/libscene.cpp) against the port's numpy build
and the JAX package's: ``make_world`` with ``use_native="require"``
gives the ``SceneData`` of ``use_native="never"`` and of the reference's
numpy ``get_shader_data`` on every array, byte for byte, for random,
clustered, degenerate (stacked), knob-varied, sphere, bunny-class and
empty scenes (the scenes of tests/test_native.py); the native OBJ,
trisrc and Radiance HDR readers equal the port's Python readers;
``use_native="require"`` raises when the library cannot be built,
``auto`` then falls back to numpy, and ``never`` builds nothing."""

import dataclasses

import numpy as np
import pytest

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
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

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
    """Identical barycenters (stacked triangles): no split."""
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
    _assert_same(native_data, ref, f"{scene} native vs the reference")


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


def test_native_build_skips_sbvh_and_reinsert():
    """The native builder makes the reference's object split only: SBVH
    and reinsertion (which needs the node list) build in Python even
    under ``require``, as in the reference."""
    ts = TriangleSet.from_arrays(*uv_sphere(lat=6, lon=8))
    for knobs in (dict(splits="sbvh"), dict(bvh_opt="reinsert")):
        w = make_world(ts, Config(use_native="require", **knobs))
        assert w.flat is None and w.bvh is not None


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
    got = obj.parse_obj(path, Config(use_native="require"))
    assert got.triangle_count == (3 if with_normals else 4)
    _assert_same_sets(got, obj.parse_obj(path, Config(use_native="never")))


def test_native_obj_reader_on_the_knot_asset():
    import os

    knot = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "knot.obj")
    _assert_same_sets(obj.parse_obj(knot, Config(use_native="require")),
                      obj.parse_obj(knot, Config(use_native="never")))
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
        obj.parse_obj(str(tmp_path / "none.obj"), Config(use_native="require"))
    notes = tmp_path / "notes.hdr"
    notes.write_bytes(b"not a radiance file\n")
    with pytest.raises(ValueError, match="not a Radiance HDR"):
        background.read_hdr(str(notes), Config(use_native="require"))


def test_native_hdr_reader_equals_python(tmp_path):
    img = procedural_sky(64).astype(np.float32)
    path = str(tmp_path / "sky.hdr")
    write_hdr(path, img)
    got = background.read_hdr(path, Config(use_native="require"))
    want = background.read_hdr(path, Config(use_native="never"))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(background.load_background(path, Config(use_native="require")), want)


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
        obj.parse_obj(path, Config(use_native="require"))
    # auto falls back to numpy, the same tables
    w = make_world(ts, Config(use_native="auto"))
    assert w.flat is None and w.bvh is not None
    _assert_same(get_shader_data(w), get_shader_data(make_world(ts, Config(use_native="never"))),
                 "auto without a compiler")
    assert not (tmp_path / "build").exists()


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
