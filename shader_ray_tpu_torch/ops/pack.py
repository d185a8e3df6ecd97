"""Host-side pack of the BINARY BVH for the stackless per-thread walk
(counterpart of shader_ray_tpu/ops/pallas/pack.pack_scene).

The reference bit-packs these tables for the TPU's scalar memory (16-bit
links and boxes, slot-major 128-lane leaf groups); a thread walking one
ray reads plain tensors:

  links  (N, 8, 2) i32   per node and ray-direction octant: the node to
                         visit next after a box hit / a box miss, -1 =
                         done (models/flatten.create_hitmiss)
  boxes  (N, 6) f32      lo.xyz, hi.xyz, exact f32
  leaf   (N, 2) i32      (first triangle, count); count 0 = inner node,
                         capped at ``max_leaf_tests`` (fs:382)
  tris   (T, 18) f32     v0 v1 v2 n0 n1 n2 per triangle in BVH order;
                         the row index is the triangle id
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.world import SceneData
from shader_ray_tpu_torch.ops.envmap import EnvPyramid


@dataclass
class PackedBinary:
    links: torch.Tensor       # (N, 8, 2) i32
    boxes: torch.Tensor       # (N, 6) f32
    leaf: torch.Tensor        # (N, 2) i32
    tris: torch.Tensor        # (T, 18) f32
    env_pyramid: EnvPyramid
    root: int
    node_count: int
    max_count: int            # largest leaf count after the cap

    def to(self, device) -> "PackedBinary":
        return PackedBinary(
            links=self.links.to(device),
            boxes=self.boxes.to(device),
            leaf=self.leaf.to(device),
            tris=self.tris.to(device),
            env_pyramid=self.env_pyramid.to(device),
            root=self.root,
            node_count=self.node_count,
            max_count=self.max_count,
        )


def pack_scene(
    data: SceneData, env: np.ndarray, config: Config | None = None
) -> PackedBinary:
    """Binary link, box, leaf and triangle tables and the env pyramid,
    as CPU tensors (``PackedBinary.to(device)`` moves them)."""
    cfg = (config or Config()).validate()
    if data.hitmiss is None:
        raise ValueError("pack_scene: SceneData carries no hit/miss links")
    counts = np.minimum(data.node_objects[:, 1], cfg.max_leaf_tests).astype(np.int32)
    leaf = np.stack([data.node_objects[:, 0].astype(np.int32), counts], axis=1)
    tris = np.concatenate([data.tri_positions, data.tri_normals], axis=1)
    return PackedBinary(
        links=torch.from_numpy(np.ascontiguousarray(data.hitmiss.transpose(1, 0, 2), np.int32)),
        boxes=torch.from_numpy(np.ascontiguousarray(data.node_boxes[:, 0:6], np.float32)),
        leaf=torch.from_numpy(np.ascontiguousarray(leaf)),
        tris=torch.from_numpy(np.ascontiguousarray(tris, np.float32)),
        env_pyramid=EnvPyramid.pack(env, cfg.env_base),
        root=int(data.tree_root),
        node_count=int(data.group_count),
        max_count=int(max(1, counts.max())) if counts.size else 1,
    )
