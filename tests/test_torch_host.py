"""The port's host copies (shader_ray_tpu_torch.models/utils/config)
against the reference package: the numpy SAH build, flatten and
node_children are equal byte for byte; fixtures, halton and mat4 are
identical; config defaults are equal."""

import dataclasses

import numpy as np
import pytest

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.models import fixtures as ref_fixtures
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.models.world import get_shader_data as ref_shader_data
from shader_ray_tpu.models.world import make_world as ref_make_world
from shader_ray_tpu.utils import halton as ref_halton
from shader_ray_tpu.utils import mat4 as ref_mat4
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models import fixtures
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.utils import halton, mat4


def _soup(n: int = 2000, seed: int = 7):
    """Seeded triangle soup: small triangles scattered in a unit box,
    with a few exact duplicates so vertex dedup has work to do."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.0, 1.0, (n, 1, 3))
    pos = (centers + rng.normal(0.0, 0.05, (n, 3, 3))).astype(np.float32)
    pos[n // 2 : n // 2 + 20] = pos[:20]
    return pos, None


SCENES = {
    "soup2k": lambda: _soup(),
    "uv_sphere": lambda: fixtures.uv_sphere(lat=12, lon=16),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_build_is_byte_identical(name):
    pos, nrm = SCENES[name]()
    ref_cfg = RefConfig()
    ref_cfg.use_native = "never"  # numpy path (native is documented bit-identical)
    ref_ts = RefTriangleSet.from_arrays(pos, nrm)
    ts = TriangleSet.from_arrays(pos, nrm)
    for f in ("positions", "normals", "colors", "indices", "tri_boxmin",
              "tri_boxmax", "barycenters", "boxmin", "boxmax"):
        a, b = getattr(ref_ts, f), getattr(ts, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f

    ref_world = ref_make_world(ref_ts, ref_cfg)
    world = make_world(ts)
    assert ref_world.scene_extent == world.scene_extent
    assert ref_world.scene_center.tobytes() == world.scene_center.tobytes()
    assert ref_world.bvh.order.tobytes() == world.bvh.order.tobytes()

    ref_data = ref_shader_data(ref_world, ref_cfg)
    data = get_shader_data(world)
    for f in ("tri_positions", "tri_normals", "node_boxes", "node_objects",
              "node_children"):
        a, b = getattr(ref_data, f), getattr(data, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for f in ("tree_root", "triangle_count", "group_count"):
        assert getattr(ref_data, f) == getattr(data, f), f


@pytest.mark.parametrize("call", [
    ("uv_sphere", dict(lat=6, lon=9, radius=0.7, center=(0.1, -0.2, 0.3))),
    ("bunny_class_scene", dict(target_tris=2000)),
    ("procedural_sky", dict(width=96)),
])
def test_fixtures_identical(call):
    name, kwargs = call
    a = getattr(ref_fixtures, name)(**kwargs)
    b = getattr(fixtures, name)(**kwargs)
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_halton_and_mat4_identical():
    for b in (2, 3, 5):
        for i in range(0, 300):
            assert ref_halton.halton(i, b) == halton.halton(i, b)
    rng = np.random.default_rng(3)
    for _ in range(5):
        a, x, y, z = rng.normal(size=4)
        n = np.sqrt(x * x + y * y + z * z)
        r0 = ref_mat4.make_rotation(a, x / n, y / n, z / n)
        r1 = mat4.make_rotation(a, x / n, y / n, z / n)
        assert r0.tobytes() == r1.tobytes()
        t0 = ref_mat4.make_translation(x, y, z)
        t1 = mat4.make_translation(x, y, z)
        assert t0.tobytes() == t1.tobytes()
        assert ref_mat4.mult(r0, t0).tobytes() == mat4.mult(r1, t1).tobytes()
        assert ref_mat4.invert(ref_mat4.mult(r0, t0)).tobytes() == \
            mat4.invert(mat4.mult(r1, t1)).tobytes()
    assert ref_mat4.identity().tobytes() == mat4.identity().tobytes()
    assert ref_mat4.to_radians(37.5) == mat4.to_radians(37.5)
    with pytest.raises(np.linalg.LinAlgError):
        mat4.invert(np.zeros((4, 4), np.float32))


def test_config_defaults_equal():
    ref = RefConfig()
    port = Config()
    fields = [f.name for f in dataclasses.fields(Config)]
    assert len(fields) == 23
    for name in fields:
        assert getattr(ref, name) == getattr(port, name), name
    for bad in (dict(env_base=100), dict(max_leaf_tests=32), dict(packet_max_steps=-1),
                dict(packet_kernel="quad"), dict(env_aniso=0)):
        with pytest.raises(ValueError):
            Config(**bad).validate()
