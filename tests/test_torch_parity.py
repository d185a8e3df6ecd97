"""The port's host layer held to the JAX package's contract, on the CPU.

* Signatures: an AST walk (nothing is imported) of every module both
  packages have.  For each public function and method of the reference,
  the port's positional parameters are the reference's, in its order, and
  its keyword-only ones start with the reference's; the port may add
  keyword-only parameters after them.  ``ALLOWED_RENAMES`` lists the
  deliberate differences, ``NOT_PORTED`` the reference's functions the
  port leaves out on purpose (ROADMAP.md, "Not queued", and A14).
* ``make_bvh``'s ``BVHStats`` and its verbose warnings are the
  reference's on the box fixture, seeded soups and tests/assets/knot.obj.
* The verbose build log, ``make_world(..., verbose=True)`` then
  ``get_shader_data(world, cfg, verbose=True)``, is the reference's line
  for line, timings masked and 1 Hz heartbeats dropped, for the numpy,
  native, SBVH and reinsertion builds of knot.obj, and so is the CLI's
  ``build_app`` on a scene-cache miss and hit.
* ``get_shader_data`` equals the reference's on every field, the vertex
  colours and split axes included, and the scene cache keeps both and
  takes a file without them for a miss.
* ``utils/mat4`` is the reference's byte for byte, function by function,
  and ``TriangleSet.from_arrays(dedup=False)`` is the reference's.
* ``vecmath.normalize(eps=)`` and ``default_frame_params(statics, fov)``
  are the reference's."""

import argparse
import ast
import contextlib
import functools
import io
import pathlib
import re
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shader_ray_tpu.app import main as ref_main
from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.config import use_config
from shader_ray_tpu.models import bvh as ref_bvh
from shader_ray_tpu.models import fixtures as ref_fixtures
from shader_ray_tpu.models import world as ref_world
from shader_ray_tpu.models.obj import parse_obj as ref_parse_obj
from shader_ray_tpu.models.triangle_set import TriangleSet as RefTriangleSet
from shader_ray_tpu.ops import vecmath as ref_vecmath
from shader_ray_tpu.ops.render import default_frame_params as ref_default_frame_params
from shader_ray_tpu.utils import mat4 as ref_mat4
from shader_ray_tpu_torch.app import main
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models import bvh, world
from shader_ray_tpu_torch.models.obj import parse_obj
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.ops import vecmath
from shader_ray_tpu_torch.ops.render import default_frame_params
from shader_ray_tpu_torch.utils import cache, mat4
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "shader_ray_tpu", ROOT / "shader_ray_tpu_torch"
KNOT = str(ROOT / "tests" / "assets" / "knot.obj")

# reference module -> the port's module of the same import name
MODULES = {str(p.relative_to(REF)): str(p.relative_to(REF)) for p in sorted(REF.rglob("*.py"))
           if (PORT / p.relative_to(REF)).exists()}
MODULES["native/__init__.py"] = "native.py"

ALLOWED_RENAMES = {
    # the XLA/Pallas engine choice is machinery the port replaces with a device
    ("engine.py", "Renderer.__init__"): {"engine": "device"},
    # the port's frame kernel takes its FrameSettings, not RenderStatics
    ("utils/kerneldiag.py", "describe_failure"): {"statics": "settings"},
    ("utils/kerneldiag.py", "report_failure"): {"statics": "settings"},
}
NOT_PORTED = {
    ("config.py", "get_config"): "the process-wide config: the port's functions take a Config",
    ("config.py", "set_config"): "the process-wide config",
    ("config.py", "use_config"): "the process-wide config",
    ("engine.py", "select_engine"): "the XLA/Pallas engine choice",
    ("models/background.py", "build_mip_pyramid"): "the TPU mip atlas",
    ("models/background.py", "pack_mip_atlas"): "the TPU mip atlas",
    ("ops/envmap.py", "sample_environment"): "the XLA wavefront engine",
    ("ops/render.py", "make_render_fn"): "the XLA wavefront engine",
    ("ops/render.py", "render_frame"): "the XLA wavefront engine",
    ("ops/render.py", "trace_rays"): "the XLA wavefront engine",
    ("parallel/mesh.py", "make_sharded_render_fn"): "shards the XLA wavefront engine",
    ("parallel/mesh.py", "shard_rays_spec"): "shards the XLA wavefront engine",
    ("utils/profiling.py", "phase"): "no path reads it: the spans and Recorder.totals replace it",
    ("utils/profiling.py", "FrameMeter.__init__"): "no path reads it: the spans replace it",
    ("utils/profiling.py", "FrameMeter.start"): "no path reads it: the spans replace it",
    ("utils/profiling.py", "FrameMeter.stop"): "no path reads it: the spans replace it",
}


def _params(fn: ast.FunctionDef) -> tuple[list[str], list[str]]:
    """(positional, keyword-only) parameter names, ``*args``/``**kw`` marked."""
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args] + (["*" + a.vararg.arg] if a.vararg else [])
    kw = [x.arg for x in a.kwonlyargs] + (["**" + a.kwarg.arg] if a.kwarg else [])
    return pos, kw


def _is_dataclass(cls: ast.ClassDef) -> bool:
    return any("dataclass" in ast.unparse(d) for d in cls.decorator_list)


def _signatures(path: pathlib.Path, generated_init: bool) -> dict:
    """Public functions and methods (and ``__init__``) of a module by
    name; with ``generated_init`` a dataclass without one gets the
    ``__init__`` its fields make (a ``field(kw_only=True)`` keyword-only)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and \
                        (not sub.name.startswith("_") or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = _params(sub)
            if generated_init and _is_dataclass(node) and f"{node.name}.__init__" not in out:
                fields = [s for s in node.body
                          if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)]
                kw_only = {s.target.id for s in fields
                           if s.value is not None and "kw_only=True" in ast.unparse(s.value)}
                out[f"{node.name}.__init__"] = (
                    ["self", *(s.target.id for s in fields if s.target.id not in kw_only)],
                    [s.target.id for s in fields if s.target.id in kw_only])
    return out


@pytest.mark.parametrize("ref_module", sorted(MODULES))
def test_signatures_start_with_the_references(ref_module):
    want = _signatures(REF / ref_module, generated_init=False)
    got = _signatures(PORT / MODULES[ref_module], generated_init=True)
    missing = {name for name in want if name not in got}
    assert missing == {name for (mod, name) in NOT_PORTED if mod == ref_module}
    for name in sorted(set(want) - missing):
        (ref_pos, ref_kw), (pos, kw) = want[name], got[name]
        renames = ALLOWED_RENAMES.get((ref_module, name), {})
        ref_pos = [renames.get(p, p) for p in ref_pos]
        assert pos == ref_pos, (name, pos, ref_pos)
        assert kw[:len(ref_kw)] == ref_kw, (name, kw, ref_kw)


def test_the_allowlists_name_what_the_reference_has():
    for (mod, name) in [*ALLOWED_RENAMES, *NOT_PORTED]:
        assert name in _signatures(REF / mod, generated_init=False), (mod, name)


# --- the build: stats, log and scene data ----------------------------------

def _soup(seed: int, n: int = 400) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.0, 1.0, size=(n, 1, 3))
    return (centers + rng.normal(scale=0.05, size=(n, 3, 3))).astype(np.float32)


def _stacked() -> np.ndarray:
    """24 copies of one triangle beside a small soup: no split separates
    the copies, a large leaf the reference warns of."""
    tri = np.array([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], np.float32)
    return np.concatenate([np.repeat(tri, 24, axis=0), _soup(3, 40)])


SCENES = {
    "box": ref_fixtures.box,
    "soup0": functools.partial(_soup, 0),
    "soup1": functools.partial(_soup, 1, 1500),
    "stacked": _stacked,
    "knot": lambda: None,
}


@functools.cache
def _sets(scene: str):
    """(port TriangleSet, reference TriangleSet) of a scene."""
    if scene == "knot":
        return parse_obj(KNOT), ref_parse_obj(KNOT)
    pos = SCENES[scene]()
    return TriangleSet.from_arrays(pos), RefTriangleSet.from_arrays(pos)


def _ref_print(stats, file=None):
    """The reference's stats print to the stderr of the moment of the call
    (its default argument holds the stderr of its import)."""
    return _REF_STATS_PRINT(stats, file or sys.stderr)


_REF_STATS_PRINT = ref_bvh.BVHStats.print


@contextlib.contextmanager
def _stderr_lines():
    """Collect what the block prints to stderr, both packages' stats
    included, into the yielded list of lines."""
    buf, lines = io.StringIO(), []
    with contextlib.redirect_stderr(buf), mock.patch.object(ref_bvh.BVHStats, "print", _ref_print):
        yield lines
    lines.extend(buf.getvalue().splitlines())


HEARTBEAT = re.compile(r"^(total shapes processed = \d+|sbvh: \d+ refs emitted, \d+ total)$")


def _masked(lines: list[str]) -> list[str]:
    """Timings masked (``… seconds``, and ``1.23s`` inside a line), the
    1 Hz heartbeats dropped: what a build log means, not when it ran."""
    out = []
    for line in lines:
        if HEARTBEAT.match(line):
            continue
        line = re.sub(r"-?\d+\.\d+ seconds$", "<t> seconds", line)
        out.append(re.sub(r"\b\d+\.\d+s\b", "<t>s", line))
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_make_bvh_stats_and_warnings_equal_the_references(scene):
    ts, ref_ts = _sets(scene)
    with _stderr_lines() as ref_log:
        want = ref_bvh.make_bvh(ref_ts.tri_boxmin, ref_ts.tri_boxmax, ref_ts.barycenters,
                                RefConfig(), verbose=True)
    with _stderr_lines() as log:
        got = bvh.make_bvh(ts.tri_boxmin, ts.tri_boxmax, ts.barycenters, Config(), verbose=True)
    assert got.stats.node_count == len(got.nodes)
    assert got.stats.leaf_count == sum(n.is_leaf for n in got.nodes)
    if scene == "stacked":
        # the reference makes a leaf of the 24 copies, past the kernels'
        # max_leaf_tests; the port splits it at the median (the leaf cap
        # split, models/bvh.py _cap_split) and says so in the log
        assert want.stats.large_leaf_no_split > 0 and any("Large leaf node" in x for x in ref_log)
        assert max(n.count for n in want.nodes) > Config().max_leaf_tests
        assert max(n.count for n in got.nodes) <= Config().max_leaf_tests
        assert any(x.startswith("Leaf cap split at ") for x in log)
        assert sorted(got.order) == sorted(want.order)
        return
    assert vars(got.stats) == vars(want.stats)
    assert _masked(log) == _masked(ref_log)
    assert np.array_equal(got.order, want.order) and got.root == want.root
    for a, b in zip(got.nodes, want.nodes, strict=True):
        assert (a.negative, a.positive, a.start, a.count, a.axis) == \
            (b.negative, b.positive, b.start, b.count, b.axis)
        assert a.boxmin.tobytes() == b.boxmin.tobytes() and a.boxmax.tobytes() == b.boxmax.tobytes()
    with _stderr_lines() as quiet:
        bvh.make_bvh(ts.tri_boxmin, ts.tri_boxmax, ts.barycenters, Config())
    assert quiet == []


BUILDS = {
    "numpy": dict(use_native="never"),
    "native": dict(use_native="require"),
    "sbvh": dict(splits="sbvh", use_native="never"),
    "reinsert": dict(bvh_opt="reinsert", use_native="never"),
}


def _ref_config(**knobs) -> RefConfig:
    cfg = RefConfig()
    for k, v in knobs.items():
        setattr(cfg, k, v)
    return cfg


@functools.cache
def _built(build: str):
    """(port SceneData, port log, reference SceneData, reference log) of
    knot.obj's verbose build and flattening."""
    ts, ref_ts = _sets("knot")
    cfg, ref_cfg = Config(**BUILDS[build]), _ref_config(**BUILDS[build])
    with _stderr_lines() as ref_log:
        want = ref_world.get_shader_data(ref_world.make_world(ref_ts, ref_cfg, True), ref_cfg,
                                         verbose=True)
    with _stderr_lines() as log:
        got = world.get_shader_data(world.make_world(ts, cfg, True), cfg, verbose=True)
    return got, log, want, ref_log


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_build_log_is_the_references(build):
    _, log, _, ref_log = _built(build)
    assert _masked(log) == _masked(ref_log)
    assert any(line.startswith("Finding scene center and extent") for line in log)
    assert log[-1].startswith("hitmiss: ")
    head = {"numpy": "BVH: ", "native": "BVH (native): ", "sbvh": "SBVH: ",
            "reinsert": "BVH: "}[build]
    assert any(line.startswith(head) for line in log)
    if build in ("numpy", "reinsert"):  # the stats block follows the numpy build's line
        at = next(i for i, line in enumerate(log) if line.startswith("BVH: "))
        assert log[at + 1].endswith(" bvh nodes") and log[at + 2].endswith(" of those are leaves")


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_shader_data_equals_the_references_on_every_field(build):
    got, _, want, _ = _built(build)
    for name, b in vars(want).items():
        a = getattr(got, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
        else:
            assert a == b, name
    R, N = got.triangle_count, got.group_count
    assert got.tri_colors.shape == (R, 9) and got.tri_colors.dtype == np.float32
    assert got.node_axis.shape == (N,) and got.node_axis.dtype == np.int32
    leaf = got.node_children[:, 0] < 0
    assert (got.node_axis[leaf] == -1).all() and np.isin(got.node_axis[~leaf], (0, 1, 2)).all()


def test_make_world_is_quiet_and_skips_the_bvh_as_the_reference():
    ts, ref_ts = _sets("box")
    cfg, ref_cfg = Config(use_native="never"), _ref_config(use_native="never")
    with _stderr_lines() as log:
        w = world.make_world(ts, cfg, False)
        quiet = world.get_shader_data(w, cfg)
    with _stderr_lines() as ref_log:
        ref_w = ref_world.make_world(ref_ts, ref_cfg, False)
    assert log == ref_log == []
    assert w.bvh is not None and ref_w.bvh is not None  # the third is verbose, not build_bvh
    assert quiet.node_axis is not None
    with _stderr_lines() as log:
        w = world.make_world(ts, cfg, True, False)
    with _stderr_lines() as ref_log:
        ref_w = ref_world.make_world(ref_ts, ref_cfg, True, False)
    assert w.bvh is None and w.flat is None and ref_w.bvh is None
    assert _masked(log) == _masked(ref_log) and log[-1].startswith("Finding scene center")


def test_scene_cache_keeps_colors_and_axes_and_misses_old_files(tmp_path, monkeypatch):
    monkeypatch.setenv("SRT_CACHE_DIR", str(tmp_path))
    data = _built("numpy")[0]
    cache.save_scene_data("c" * 24, data)
    back = cache.load_scene_data("c" * 24)
    for name in ("tri_colors", "node_axis", "tri_positions", "hitmiss", "node_children"):
        a, b = getattr(back, name), getattr(data, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    with np.load(cache._path("c" * 24)) as z:  # a file of the format before both fields
        old = {k: z[k] for k in z.files if k not in ("tri_colors", "node_axis")}
    np.savez_compressed(cache._path("o" * 24)[:-len(".npz")], **old)
    assert cache.load_scene_data("o" * 24) is None
    rebuilt = cache.cached_scene_data("o" * 24, lambda: data)
    assert rebuilt is data and cache.load_scene_data("o" * 24).node_axis is not None


def _cli_args(tmp_path, **extra):
    return argparse.Namespace(model=KNOT, background="grid", width=16, height=16, devices=1,
                              **extra)


def test_cli_build_log_is_the_references_on_a_miss_and_a_hit(tmp_path, monkeypatch):
    monkeypatch.setenv("SRT_CACHE_DIR", str(tmp_path))
    logs = {}
    for run in ("miss", "hit"):
        with _stderr_lines() as ref_log, use_config(RefConfig.from_env()):
            ref_main.build_app(_cli_args(tmp_path, engine="auto"))
        with _stderr_lines() as log:
            main.build_app(_cli_args(tmp_path, device="cpu"))
        assert ref_log[-1].startswith("engine: ") and log[-1] == "device: cpu"
        assert _masked(log[:-1]) == _masked(ref_log[:-1]), run
        logs[run] = log
    assert logs["miss"][-2].startswith("hitmiss: ") and logs["hit"][0].startswith("scene cache hit")
    for line in ("BVH", "hitmiss"):
        assert any(x.startswith(line) for x in logs["miss"])
        assert not any(x.startswith(line) for x in logs["hit"])


# --- the helpers ---------------------------------------------------------------

MATRICES = [
    np.eye(4, dtype=np.float32),
    ref_mat4.make_translation(0.5, -2.0, 3.25),
    ref_mat4.mult(ref_mat4.make_rotation(0.7, 0.0, 0.6, 0.8), ref_mat4.make_scale(1.5, 0.5, 2.0)),
    np.random.default_rng(4).normal(size=(4, 4)).astype(np.float32),
]
POINTS = [np.zeros(3, np.float32), np.array([1.0, -2.0, 0.25], np.float32),
          np.random.default_rng(5).normal(size=3).astype(np.float32)]
MAT4_CALLS = {
    "identity": [()],
    "make_translation": [(1.0, 2.0, 3.0), (-0.5, 1e-3, 7.25)],
    "make_scale": [(1.0, 2.0, 3.0), (-0.5, 1e-3, 7.25)],
    "make_rotation": [(0.3, 0.0, 0.0, 1.0), (-2.0, 0.48, 0.6, 0.64)],
    "mult": [(a, b) for a in MATRICES for b in MATRICES[1:]],
    "transpose": [(m,) for m in MATRICES],
    "invert": [(m,) for m in MATRICES],
    "zero_bottom_row": [(m,) for m in MATRICES],
    "transform_point": [(m, p) for m in MATRICES for p in POINTS],
    "transform_vector": [(m, p) for m in MATRICES for p in POINTS],
    "get_rotation": [(ref_mat4.make_rotation(a, 0.48, 0.6, 0.64),) for a in (0.0, 0.4, 2.5)],
    "rotation_mult_rotation": [(np.array([0.3, 0, 0, 1], np.float32),
                                np.array([1.1, 0.6, 0.8, 0], np.float32))],
    "to_radians": [(d,) for d in (0.0, 40.0, -135.5)],
    "to_degrees": [(r,) for r in (0.0, 1.0, -np.pi / 3, 12.5)],
}


def test_mat4_calls_cover_the_references_functions():
    assert set(MAT4_CALLS) == set(_signatures(REF / "utils/mat4.py", generated_init=False))


@pytest.mark.parametrize("name", sorted(MAT4_CALLS))
def test_mat4_function_matches_the_reference_byte_for_byte(name):
    for args in MAT4_CALLS[name]:
        got, want = getattr(mat4, name)(*args), getattr(ref_mat4, name)(*args)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), (name, args)
        else:
            assert type(got) is type(want) and got == want, (name, args)
    if name == "to_degrees":
        for r in (0.0, 1.0, -np.pi / 3, 12.5):
            assert mat4.to_radians(mat4.to_degrees(r)) == pytest.approx(r)


@pytest.mark.parametrize("scene", ["box", "soup0"])
def test_from_arrays_without_dedup_equals_the_references(scene):
    pos = SCENES[scene]()
    nrm = np.random.default_rng(6).normal(size=pos.shape).astype(np.float32)
    got = TriangleSet.from_arrays(pos, nrm, None, dedup=False)
    want = RefTriangleSet.from_arrays(pos, nrm, None, dedup=False)
    for name in ("positions", "normals", "colors", "indices", "tri_boxmin", "tri_boxmax",
                 "barycenters", "boxmin", "boxmax"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert got.vertex_count == 3 * got.triangle_count == 3 * len(pos)
    assert TriangleSet.from_arrays(pos).vertex_count == RefTriangleSet.from_arrays(pos).vertex_count


def test_normalize_eps_and_default_frame_params_match_the_references():
    v = np.array([[3.0, 4.0, 0.0], [0.0, 0.0, 0.0], [1e-3, 0.0, 0.0]], np.float32)
    for eps in (0.0, 1e-2):
        got = vecmath.normalize(torch.from_numpy(v), eps).numpy()
        want = np.asarray(ref_vecmath.normalize(jnp.asarray(v), eps))
        assert np.array_equal(got, want, equal_nan=True), eps
    fov = np.deg2rad(55.0)
    got, want = default_frame_params(None, fov), ref_default_frame_params(None, fov)
    for name in want._fields:
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
