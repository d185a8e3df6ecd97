"""World: scene load, build and the flattened scene data the packer
reads (reference world.cpp:46-134, 298-347; numpy path of
shader_ray_tpu/models/world.py).  ``load_world`` dispatches on the file
extension (.trisrc, .obj); the World carries the view matrices the app
sets (app/camera.update_view_params)."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.bvh import BVH, make_bvh
from shader_ray_tpu_torch.models.flatten import flatten_bvh
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.utils import mat4


@dataclass
class Camera:
    """Reference world.h camera: just a field of view (radians)."""

    fov: float = mat4.to_radians(40.0)  # ray.cpp:1078


@dataclass
class World:
    triangles: TriangleSet
    bvh: BVH | None  # None when loaded with build_bvh=False
    scene_center: np.ndarray
    scene_extent: float
    triangle_count: int
    cam: Camera = field(default_factory=Camera)
    # view matrices, set by app.camera.update_view_params (reference
    # world.h:44-59)
    camera_matrix: np.ndarray = field(default_factory=mat4.identity)
    camera_normal_matrix: np.ndarray = field(default_factory=mat4.identity)
    object_matrix: np.ndarray = field(default_factory=mat4.identity)
    object_inverse: np.ndarray = field(default_factory=mat4.identity)
    object_normal_matrix: np.ndarray = field(default_factory=mat4.identity)
    object_normal_inverse: np.ndarray = field(default_factory=mat4.identity)


@dataclass
class SceneData:
    """Flattened scene (reference scene_shader_data, world.h:68-93).
    Triangle arrays are in BVH order and unindexed, (T, 9) per
    triangle: leaf (start, count) ranges index them directly."""

    tri_positions: np.ndarray   # (T, 9) f32: v0 v1 v2
    tri_normals: np.ndarray     # (T, 9) f32: n0 n1 n2
    node_boxes: np.ndarray      # (N, 8) f32: boxmin(3) boxmax(3) pad(2)
    node_objects: np.ndarray    # (N, 2) i32: (start, count); (0,0) for branch
    node_children: np.ndarray   # (N, 2) i32: (negative, positive), -1 for leaf
    tree_root: int
    triangle_count: int
    group_count: int
    hitmiss: np.ndarray | None = None  # (8, N, 2) i32 per-octant (hit, miss) links


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

        triangles = parse_obj(filename)
    else:
        raise ValueError(f"This program doesn't know how to load a file with extension {ext}")
    if verbose:
        print(f"Parsing: {time.monotonic() - then:f} seconds", file=sys.stderr)
        print(f"{triangles.triangle_count} triangles.", file=sys.stderr)
    then = time.monotonic()
    world = make_world(triangles, cfg, build_bvh)
    if verbose and build_bvh:
        print(f"BVH: {time.monotonic() - then:f} seconds", file=sys.stderr)
    return world


def make_world(
    triangles: TriangleSet, config: Config | None = None, build_bvh: bool = True
) -> World:
    """Scene center (AABB center), extent (2x the largest vertex
    distance from it, world.cpp:106-117) and the SAH BVH."""
    cfg = config or Config()
    tcount = triangles.triangle_count
    scene_center = triangles.box_center()
    if tcount > 0:
        d = scene_center[None, None, :] - triangles.positions[triangles.indices]
        scene_extent = float(np.sqrt((d * d).sum(axis=-1).max())) * 2.0
    else:
        scene_extent = 1.0
    bvh = make_bvh(
        triangles.tri_boxmin, triangles.tri_boxmax, triangles.barycenters, cfg
    ) if build_bvh else None
    return World(
        triangles=triangles, bvh=bvh, scene_center=scene_center,
        scene_extent=scene_extent, triangle_count=tcount,
    )


def get_shader_data(world: World) -> SceneData:
    """Flatten a World into SceneData (world.cpp:298-347)."""
    flat = flatten_bvh(world.bvh)
    order = world.bvh.order
    ts = world.triangles
    T = len(order)
    if T > 0:
        idx = ts.indices[order]
        tri_positions = ts.positions[idx].reshape(T, 9)
        tri_normals = ts.normals[idx].reshape(T, 9)
    else:
        tri_positions = np.zeros((1, 9), np.float32)
        tri_normals = np.zeros((1, 9), np.float32)
    n = flat.node_count
    node_boxes = np.zeros((n, 8), np.float32)
    node_boxes[:, 0:3] = flat.boxmin
    node_boxes[:, 3:6] = flat.boxmax
    return SceneData(
        tri_positions=np.ascontiguousarray(tri_positions, np.float32),
        tri_normals=np.ascontiguousarray(tri_normals, np.float32),
        node_boxes=node_boxes,
        node_objects=np.stack([flat.start, flat.count], axis=1).astype(np.int32),
        node_children=flat.children,
        tree_root=flat.root,
        triangle_count=T,
        group_count=n,
        hitmiss=flat.hitmiss,
    )
