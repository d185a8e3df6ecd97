"""The port's copies of the reference's last helpers, against the
reference: the scene fixtures (``single_triangle``, ``quad``, ``box``,
``terrain_scene``) array for array; the brute-force oracle
(``ops/reference.py``: ``intersect_brute``, ``sample_env_bilinear``,
``render_reference``) against the reference's numpy oracle to 1e-5
(``intersect_brute`` chunked over the triangles, so its chunks are held
too); the incremental, vertex-deduplicating ``TriangleSet`` builder
against the reference's on the fixtures and a small OBJ (vertex count,
indices, triangles), with ``make_world(verbose=True)``'s count lines.
``mat4`` is held to the reference function by function in
tests/test_torch_parity.py."""

import numpy as np
import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models import fixtures as ref_fixtures
from shader_ray_tpu.models.obj import parse_obj_text as ref_parse_obj_text
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.models.world import make_world as ref_make_world
from shader_ray_tpu.ops import reference as ref_oracle
from shader_ray_tpu.utils import mat4 as ref_mat4
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models import fixtures
from shader_ray_tpu_torch.models.obj import parse_obj_text
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import make_world
from shader_ray_tpu_torch.ops import reference as oracle
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIXTURES = {
    "single_triangle": ((), {}),
    "quad": ((), {}),
    "quad-args": ((0.25,), {"half": 1.5}),
    "box": ((), {}),
    "box-args": (((0.5, -1.0, 2.0),), {"half": 0.3}),
    "terrain_scene": ((2000,), {}),
}

OBJ = """o wedge
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vn 0 0 -1
f 1 2 3 4
f 1//1 2//1 5//1
f 2 3 5
f 3 4 5
f 4 1 5
"""


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    if a is None:
        assert b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_equals_reference(name):
    fn = name.split("-")[0]
    args, kw = FIXTURES[name]
    _equal(getattr(fixtures, fn)(*args, **kw), getattr(ref_fixtures, fn)(*args, **kw))


def _rays(seed: int, n: int):
    rng = np.random.default_rng(seed)
    P = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    D = rng.normal(size=(n, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    D[:16] = [0.0, 0.0, 1.0]
    return P, D


@pytest.mark.parametrize("pairs", [oracle.PAIRS, 1 << 12])
def test_intersect_brute_matches_reference(monkeypatch, pairs):
    monkeypatch.setattr(oracle, "PAIRS", pairs)  # 1 << 12: a chunk of 8 triangles
    pos, _ = ref_fixtures.bunny_class_scene(1000)
    P, D = _rays(51, 512)
    want = ref_oracle.intersect_brute(pos, P, D)
    got = oracle.intersect_brute(torch.from_numpy(pos), torch.from_numpy(P), torch.from_numpy(D))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    hit = want[0] < ref_oracle.INFINITELY_FAR
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_allclose(g.numpy()[hit], w[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0].numpy()[~hit], want[0][~hit])
    # numpy inputs, on the device asked for
    t, which, _, _ = oracle.intersect_brute(pos, P, D, device="cpu")
    np.testing.assert_array_equal(which.numpy(), want[1])


def test_sample_env_bilinear_matches_reference():
    env = ref_fixtures.procedural_sky(64)
    _, D = _rays(52, 4096)
    D[16:20] = [[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]]
    got = oracle.sample_env_bilinear(env, torch.from_numpy(D)).numpy()
    np.testing.assert_allclose(got, ref_oracle.sample_env_bilinear(env, D), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("diffuse", [(0.0, 0.0, 0.0), (0.8, 0.2, 0.2)])
def test_render_reference_matches_reference(diffuse):
    pos, nrm = ref_fixtures.uv_sphere(lat=8, lon=12)
    env = ref_fixtures.procedural_sky(64)
    cam = ref_mat4.make_translation(0.0, 0.0, 3.0)
    rot = ref_mat4.make_rotation(0.4, 0.0, 1.0, 0.0)
    kw = dict(camera_matrix=cam, object_matrix=ref_mat4.invert(rot),
              object_normal_matrix=ref_mat4.invert(rot), object_normal_inverse=rot,
              light_dir=(0.36, 0.48, 0.8), diffuse_color=diffuse)
    want = ref_oracle.render_reference(pos, nrm, env, 8, 8, **kw)
    got = oracle.render_reference(pos, nrm, env, 8, 8, device="cpu", **kw)
    assert got.dtype == torch.float32 and got.shape == (8, 8, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert want.std() > 1e-2


def _builders(tri_pos, tri_norm, tri_col):
    ref, port = RefTriangleSet(), TriangleSet()
    ref.add_batch(tri_pos, tri_norm, tri_col)
    port.add_batch(tri_pos, tri_norm, tri_col)
    assert port.vertex_count == ref.vertex_count and port.triangle_count == ref.triangle_count
    return ref.finish(), port.finish()


@pytest.mark.parametrize("name", ["single_triangle", "quad", "box", "sphere"])
def test_triangle_set_builder_matches_reference(name):
    if name == "sphere":
        pos, nrm = ref_fixtures.uv_sphere(lat=6, lon=8)
    else:
        pos = getattr(ref_fixtures, name)()
        nrm = np.zeros_like(pos)  # shared corners dedup to one vertex
    col = np.ones_like(pos)
    ref, port = _builders(pos, nrm, col)
    assert port.vertex_count == ref.vertex_count < 3 * len(pos) or name == "single_triangle"
    np.testing.assert_array_equal(port.indices, ref.indices)
    for f in ("positions", "normals", "colors", "tri_boxmin", "tri_boxmax", "barycenters",
              "boxmin", "boxmax"):
        assert getattr(port, f).tobytes() == getattr(ref, f).tobytes(), f
    for i in range(port.triangle_count):
        assert port.get(i).tobytes() == ref.get(i).tobytes()
    # the one-shot build numbers the vertices alike
    arrays = TriangleSet.from_arrays(pos, nrm, col)
    assert arrays.vertex_count == port.vertex_count
    np.testing.assert_array_equal(arrays.indices, port.indices)
    # one triangle at a time: add returns each index
    one = TriangleSet()
    assert [one.add(p, n, c) for p, n, c in zip(pos, nrm, col)] == list(range(len(pos)))
    np.testing.assert_array_equal(one.finish().indices, ref.indices)


def test_triangle_set_builder_on_an_obj_and_empty():
    ref, port = ref_parse_obj_text(OBJ), parse_obj_text(OBJ)
    assert port.vertex_count == ref.vertex_count and port.triangle_count == ref.triangle_count
    np.testing.assert_array_equal(port.indices, ref.indices)
    for i in range(port.triangle_count):
        assert port.get(i).tobytes() == ref.get(i).tobytes()
    tri = np.stack([port.get(i) for i in range(port.triangle_count)])
    nrm = port.normals[port.indices]
    built = TriangleSet()
    built.add_batch(tri, nrm, np.ones_like(tri))
    built.finish()
    assert built.vertex_count == port.vertex_count
    np.testing.assert_array_equal(built.indices, port.indices)
    empty, ref_empty = TriangleSet().finish(), RefTriangleSet().finish()
    assert (empty.vertex_count, empty.triangle_count) == (ref_empty.vertex_count, 0)
    assert empty.boxmin.tobytes() == ref_empty.boxmin.tobytes()
    assert parse_obj_text("o nothing\n").triangle_count == 0


def test_make_world_prints_the_reference_counts(capsys):
    pos = ref_fixtures.box()
    ref_ts = RefTriangleSet.from_arrays(pos)
    cfg = RefConfig()
    cfg.use_native = "never"
    ref_make_world(ref_ts, cfg, verbose=True)
    want = capsys.readouterr().err.splitlines()[:3]
    make_world(TriangleSet.from_arrays(pos), Config(use_native="never"), verbose=True)
    got = capsys.readouterr().err.splitlines()
    assert got[:3] == want and want == ["12 triangles.", "24 independent vertices.",
                                        "2.00 vertices per triangle."]
    # the build log follows, line for line the reference's (tests/test_torch_parity.py)
    assert got[3].startswith("Finding scene center and extent: ") and got[4].startswith("BVH: ")
    make_world(TriangleSet.from_arrays(pos), Config(use_native="never"))
    assert capsys.readouterr().err == ""

