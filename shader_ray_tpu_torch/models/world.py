"""World: scene load, build and the flattened scene data the packer
reads (reference world.cpp:46-134, 298-347; numpy path of
shader_ray_tpu/models/world.py).  ``load_world`` dispatches on the file
extension (.trisrc, .obj); ``make_world`` builds the BVH the
configuration asks for (``Config.splits``, ``Config.bvh_opt``), the
object-split and the spatial-split one through the native builder where
``Config.use_native`` lets it (native.py: flattened as it builds,
bit-identical to the numpy builds); the World carries the view matrices
the app sets (app/camera.update_view_params); ``scene_fingerprint`` keys
the scene cache (utils/cache.py)."""

from __future__ import annotations

import hashlib
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from shader_ray_tpu_torch import native
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.bvh import BVH, make_bvh
from shader_ray_tpu_torch.models.flatten import FlatBVH, flatten_bvh
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.utils import mat4
from shader_ray_tpu_torch.utils.profiling import span


@dataclass
class Camera:
    """Reference world.h camera: just a field of view (radians)."""

    fov: float = mat4.to_radians(40.0)  # ray.cpp:1078


@dataclass
class BuildCounts:
    """What ``make_world``'s build made: its route (``object``,
    ``object-native``, ``sbvh``, ``sbvh-native``), the triangle references
    R, the spatial splits taken, the nodes and the leaves."""

    route: str
    references: int
    spatial_splits: int
    nodes: int
    leaves: int


@dataclass
class World:
    triangles: TriangleSet
    bvh: BVH | None  # None with build_bvh=False or from the native builder
    scene_center: np.ndarray
    scene_extent: float
    triangle_count: int
    flat: FlatBVH | None = None      # the native builder's flattened BVH
    order: np.ndarray | None = None  # the native builder's triangle order
    counts: BuildCounts | None = None  # the build's counts, None with build_bvh=False
    cam: Camera = field(default_factory=Camera)
    # view matrices, set by app.camera.update_view_params (reference
    # world.h:44-59)
    camera_matrix: np.ndarray = field(default_factory=mat4.identity)
    camera_normal_matrix: np.ndarray = field(default_factory=mat4.identity)
    object_matrix: np.ndarray = field(default_factory=mat4.identity)
    object_inverse: np.ndarray = field(default_factory=mat4.identity)
    object_normal_matrix: np.ndarray = field(default_factory=mat4.identity)
    object_normal_inverse: np.ndarray = field(default_factory=mat4.identity)

    @property
    def tri_order(self) -> np.ndarray:
        """The BVH's triangle order, whichever builder made it."""
        return self.order if self.order is not None else self.bvh.order


@dataclass
class SceneData:
    """Flattened scene (reference scene_shader_data, world.h:68-93).
    Triangle arrays are in BVH order and unindexed, (R, 9) per triangle
    reference: leaf (start, count) ranges index them directly.  R = T
    for the object-split build; the SBVH build may list a triangle more
    than once, and ``triangle_count`` is then R."""

    tri_positions: np.ndarray   # (R, 9) f32: v0 v1 v2
    tri_normals: np.ndarray     # (R, 9) f32: n0 n1 n2
    tri_colors: np.ndarray      # (R, 9) f32: c0 c1 c2
    node_boxes: np.ndarray      # (N, 8) f32: boxmin(3) boxmax(3) pad(2)
    node_objects: np.ndarray    # (N, 2) i32: (start, count); (0,0) for branch
    node_children: np.ndarray   # (N, 2) i32: (negative, positive), -1 for leaf
    tree_root: int
    triangle_count: int
    group_count: int
    hitmiss: np.ndarray | None = None    # (8, N, 2) i32 per-octant (hit, miss) links
    node_axis: np.ndarray | None = None  # (N,) i32 split axis, -1 for leaf


def load_world(
    filename: str, config: Config | None = None, verbose: bool = True, build_bvh: bool = True
) -> World:
    """Load a .trisrc or .obj scene and build its World (reference
    load_world, world.cpp:46-134); ``build_bvh=False`` skips the BVH,
    leaving only the center, extent and view matrices."""
    cfg = config or Config()
    ext = filename.rsplit(".", 1)[-1] if "." in filename else ""
    then = time.monotonic()
    if ext == "trisrc":
        from shader_ray_tpu_torch.models.trisrc import parse_trisrc

        triangles = parse_trisrc(filename, cfg)
    elif ext == "obj":
        from shader_ray_tpu_torch.models.obj import parse_obj

        triangles = parse_obj(filename, config=cfg)
    else:
        raise ValueError(f"This program doesn't know how to load a file with extension {ext}")
    if verbose:
        print(f"Parsing: {time.monotonic() - then:f} seconds", file=sys.stderr)
    return make_world(triangles, cfg, verbose=verbose, build_bvh=build_bvh)


def _log_seconds(what: str, then: float) -> None:
    print(f"{what}: {time.monotonic() - then:f} seconds", file=sys.stderr)


def make_world(
    triangles: TriangleSet, config: Config | None = None, verbose: bool = False,
    build_bvh: bool = True,
) -> World:
    """Scene center (AABB center), extent (2x the largest vertex
    distance from it, world.cpp:106-117) and the BVH: the binned-SAH
    object-split build, or with ``splits="sbvh"`` the spatial-split one,
    then with ``bvh_opt="reinsert"`` the reinsertion optimizer
    (shader_ray_tpu/models/world.py:119-232).  Either split without
    reinsertion (which needs the node list) goes through the native
    builder where ``Config.use_native`` lets it.  The build is the span
    ``world.bvh:<route>`` and its counts are the World's ``counts``.
    ``verbose`` prints the reference's build log to stderr: the triangle
    and vertex counts, the center and extent's seconds, then "BVH" with
    ``BVHStats``, "BVH (native)" with its node and leaf counts, "SBVH", or
    "SBVH (native)" with its node, leaf, reference and spatial split
    counts, and passes ``verbose`` on to the builders."""
    cfg = config or Config()
    tcount = triangles.triangle_count
    if verbose:
        print(f"{tcount} triangles.", file=sys.stderr)
        print(f"{triangles.vertex_count} independent vertices.", file=sys.stderr)
        if tcount:
            print(f"{triangles.vertex_count / tcount:.2f} vertices per triangle.",
                  file=sys.stderr)
    then = time.monotonic()
    scene_center = triangles.box_center()
    if tcount > 0:
        d = scene_center[None, None, :] - triangles.positions[triangles.indices]
        scene_extent = float(np.sqrt((d * d).sum(axis=-1).max())) * 2.0
    else:
        scene_extent = 1.0
    if verbose:
        _log_seconds("Finding scene center and extent", then)
    bvh = flat = order = counts = None
    if build_bvh:
        fast = cfg.bvh_opt != "reinsert" and native.wanted(cfg.use_native)
        route = cfg.splits + ("-native" if fast else "")
        then = time.monotonic()
        with span(f"world.bvh:{route}"):
            bvh, flat, order, counts = _build(triangles, cfg, route, verbose, then)
    return World(
        triangles=triangles, bvh=bvh, scene_center=scene_center,
        scene_extent=scene_extent, triangle_count=tcount, flat=flat, order=order,
        counts=counts,
    )


def _build(triangles: TriangleSet, cfg: Config, route: str, verbose: bool, then: float):
    """(bvh, flat, order, BuildCounts) of ``make_world``'s build by
    ``route``: the numpy builds give the node list, the native ones the
    flattened tree and its order."""
    tcount = triangles.triangle_count
    bvh = flat = order = None
    splits = 0
    if route == "object-native":
        flat, order, leaves = native.build_flat_bvh(
            triangles.tri_boxmin, triangles.tri_boxmax, triangles.barycenters,
            leaf_max=cfg.bvh_leaf_max, max_depth=cfg.bvh_max_depth,
            ctrav=cfg.sah_ctrav, cisec=cfg.sah_cisec, leaf_cap=cfg.max_leaf_tests,
        )
        if verbose:
            _log_seconds("BVH (native)", then)
    elif route.startswith("sbvh"):
        verts = triangles.positions[triangles.indices] if tcount else np.zeros((0, 3, 3), np.float32)
        if route == "sbvh-native":
            flat, order, leaves, splits = native.build_flat_sbvh(
                verts, leaf_max=cfg.bvh_leaf_max, max_depth=cfg.bvh_max_depth,
                ctrav=cfg.sah_ctrav, cisec=cfg.sah_cisec, leaf_cap=cfg.max_leaf_tests,
            )
            if verbose:
                _log_seconds("SBVH (native)", then)
        else:
            from shader_ray_tpu_torch.models.sbvh import make_sbvh

            bvh = make_sbvh(verts, cfg, verbose=verbose)
            if verbose:
                _log_seconds("SBVH", then)
    else:
        bvh = make_bvh(triangles.tri_boxmin, triangles.tri_boxmax, triangles.barycenters, cfg,
                       verbose=verbose)
        if verbose:
            _log_seconds("BVH", then)
            bvh.stats.print()
    if bvh is not None and cfg.bvh_opt == "reinsert":
        from shader_ray_tpu_torch.models.optimize import optimize_bvh

        bvh = optimize_bvh(bvh, cfg, verbose=verbose)
    if bvh is not None:
        counts = BuildCounts(route, len(bvh.order), bvh.spatial_splits, bvh.node_count,
                             sum(n.is_leaf for n in bvh.nodes))
    else:
        counts = BuildCounts(route, len(order), splits, flat.node_count, leaves)
        if verbose:
            print(f"{counts.nodes} bvh nodes", file=sys.stderr)
            print(f"{counts.leaves} of those are leaves", file=sys.stderr)
            if route == "sbvh-native":
                print(f"{counts.references} references for {tcount} triangles, "
                      f"{counts.spatial_splits} spatial splits", file=sys.stderr)
    return bvh, flat, order, counts


def get_shader_data(world: World, config: Config | None = None, verbose: bool = False) -> SceneData:
    """Flatten a World into SceneData (world.cpp:298-347), the triangle
    tables sized by the reference count R = len(order).  ``verbose``
    prints the flattening's "hitmiss" seconds to stderr, as the
    reference's; ``config`` is the reference's parameter, which its
    flattening does not read either."""
    with span("world.shader_data"):
        return _shader_data(world, verbose)


def _shader_data(world: World, verbose: bool) -> SceneData:
    then = time.monotonic()
    flat = world.flat if world.flat is not None else flatten_bvh(world.bvh)
    if verbose:
        _log_seconds("hitmiss", then)
    order = world.tri_order
    ts = world.triangles
    R = len(order)
    if R > 0:
        idx = ts.indices[order]
        tri_positions = ts.positions[idx].reshape(R, 9)
        tri_normals = ts.normals[idx].reshape(R, 9)
        tri_colors = ts.colors[idx].reshape(R, 9)
    else:
        tri_positions, tri_normals, tri_colors = (np.zeros((1, 9), np.float32) for _ in range(3))
    n = flat.node_count
    node_boxes = np.zeros((n, 8), np.float32)
    node_boxes[:, 0:3] = flat.boxmin
    node_boxes[:, 3:6] = flat.boxmax
    return SceneData(
        tri_positions=np.ascontiguousarray(tri_positions, np.float32),
        tri_normals=np.ascontiguousarray(tri_normals, np.float32),
        tri_colors=np.ascontiguousarray(tri_colors, np.float32),
        node_boxes=node_boxes,
        node_objects=np.stack([flat.start, flat.count], axis=1).astype(np.int32),
        node_children=flat.children,
        tree_root=flat.root,
        triangle_count=R,
        group_count=n,
        hitmiss=flat.hitmiss,
        node_axis=flat.axis,
    )


def scene_fingerprint(filename: str, config: Config | None = None) -> str:
    """The scene cache's key: a hash of the file's bytes and of the build
    knobs that change the built tables (shader_ray_tpu/models/world.py:283-297)."""
    cfg = config or Config()
    h = hashlib.sha256()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    key = (
        f"{cfg.bvh_leaf_max}|{cfg.bvh_max_depth}|{cfg.sah_ctrav}|{cfg.sah_cisec}"
        f"|{cfg.colors_are_linear}|{cfg.geometry_scale}|{cfg.splits}|v1"
        + (f"|opt={cfg.bvh_opt}" if cfg.bvh_opt else "")
    )
    h.update(key.encode())
    return h.hexdigest()[:24]
