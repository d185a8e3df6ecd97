"""Host-side pack of the BINARY BVH for the stackless per-thread walk
(counterpart of shader_ray_tpu/ops/pallas/pack.pack_scene).

The reference bit-packs these tables for the TPU's scalar memory (16-bit
links and boxes, slot-major 128-lane leaf groups); a thread walking one
ray reads plain tensors laid out for one 32-byte sector a step:

  nodes    (8, N, 8) f32  one bank per ray-direction octant, its nodes
                          renumbered in the order that octant's
                          stackless walk visits them (near child first,
                          models/flatten.create_hitmiss): the root is
                          record 0 and an inner node's near child is the
                          next record.  A record is (lo.xyz, miss) and
                          (hi.xyz, leaf) with int32 bits in the .w
                          slots: ``miss`` the record to visit after a
                          box miss, -1 = done (a leaf's hit and miss
                          links are equal, so a leaf goes to ``miss``
                          either way); ``leaf`` = first triangle | count
                          << 26 for a leaf (count capped at
                          ``max_leaf_tests``, fs:382), -1 for an inner
                          node.  Boxes are exact f32.  ``bank_order``
                          gives a bank's records as DFS node indices
                          (the numbering of SceneData and ``hitmiss``).
  tris     (T, 12) f32    per triangle in BVH order v0, e0 = v1 - v0,
                          e1 = v0 - v2, each padded to a float4: the
                          Moller-Trumbore operands, rounded exactly as
                          the test computed them from v0 v1 v2
  normals  (T, 12) f32    n0, n1 - n0, n2 - n0, each padded to a float4,
                          read once a ray after its walk

The row index of ``tris`` and ``normals`` is the triangle id.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.world import SceneData
from shader_ray_tpu_torch.ops.envmap import EnvPyramid
from shader_ray_tpu_torch.ops.pack_wide import COUNT_SHIFT, FIRST_MASK, capped_counts

BANKS = 8
INNER = -1  # the leaf field of an inner node


@dataclass
class PackedBinary:
    nodes: torch.Tensor       # (8, N, 8) f32 (miss and leaf as int32 bits)
    tris: torch.Tensor        # (T, 12) f32
    normals: torch.Tensor     # (T, 12) f32
    env_pyramid: EnvPyramid
    node_count: int
    max_count: int            # largest leaf count after the cap

    @property
    def miss(self) -> torch.Tensor:
        """(8, N) i32 miss links in each bank's numbering, a view."""
        return self.nodes.view(torch.int32)[..., 3]

    @property
    def leaf(self) -> torch.Tensor:
        """(8, N) i32 first | count << 26, or -1 for an inner node, a view."""
        return self.nodes.view(torch.int32)[..., 7]

    def to(self, device) -> "PackedBinary":
        return PackedBinary(
            nodes=self.nodes.to(device),
            tris=self.tris.to(device),
            normals=self.normals.to(device),
            env_pyramid=self.env_pyramid.to(device),
            node_count=self.node_count,
            max_count=self.max_count,
        )


def bank_order(hitmiss: np.ndarray, root: int) -> np.ndarray:
    """One bank's nodes in the order its stackless walk visits them when
    every box is hit: the hit links followed from the root, as DFS node
    indices, (N,) i32.  Raises unless that chain visits every node once;
    then each inner node's hit link is the next record by construction
    (the near-first preorder of create_hitmiss)."""
    n = hitmiss.shape[0]
    order = np.full(n, -1, np.int64)
    g, i = root, 0
    while g != -1 and i < n:
        order[i] = g
        g = int(hitmiss[g, 0])
        i += 1
    if g != -1 or i != n or len(np.unique(order)) != n:
        raise ValueError("the hit links do not visit every node once")
    return order.astype(np.int32)


def pack_scene(
    data: SceneData, env: np.ndarray, config: Config | None = None
) -> PackedBinary:
    """Per-octant node banks, triangle and normal tables and the env
    pyramid, as CPU tensors (``PackedBinary.to(device)`` moves them)."""
    cfg = (config or Config()).validate()
    if data.hitmiss is None:
        raise ValueError("pack_scene: SceneData carries no hit/miss links")
    if data.triangle_count > FIRST_MASK:
        raise ValueError("scene too large for the 26-bit leaf field")
    N = int(data.group_count)
    counts = capped_counts(data, cfg).astype(np.int64)
    is_leaf = data.node_children[:, 0] < 0
    leaf_field = np.where(is_leaf, (counts << COUNT_SHIFT) | data.node_objects[:, 0], INNER)
    nodes = np.zeros((BANKS, N, 8), np.float32)
    bits = nodes.view(np.int32)
    for o in range(BANKS):
        links = data.hitmiss[o]
        order = bank_order(links, int(data.tree_root))
        pos = np.append(np.argsort(order), -1)        # pos[-1] = -1: done
        if not (links[order, 0][is_leaf[order]] == links[order, 1][is_leaf[order]]).all():
            raise ValueError("a leaf's hit and miss links differ")
        nodes[o, :, 0:3] = data.node_boxes[order, 0:3]
        nodes[o, :, 4:7] = data.node_boxes[order, 3:6]
        bits[o, :, 3] = pos[links[order, 1]]
        bits[o, :, 7] = leaf_field[order]
    tp = data.tri_positions.astype(np.float32)
    v0, v1, v2 = tp[:, 0:3], tp[:, 3:6], tp[:, 6:9]
    tn = data.tri_normals.astype(np.float32)
    n0, n1, n2 = tn[:, 0:3], tn[:, 3:6], tn[:, 6:9]
    tris = np.zeros((len(tp), 12), np.float32)
    normals = np.zeros((len(tn), 12), np.float32)
    for j, (a, b) in enumerate(((v0, n0), (v1 - v0, n1 - n0), (v0 - v2, n2 - n0))):
        tris[:, 4 * j:4 * j + 3] = a
        normals[:, 4 * j:4 * j + 3] = b
    leaf_counts = counts[is_leaf]
    return PackedBinary(
        nodes=torch.from_numpy(nodes),
        tris=torch.from_numpy(tris),
        normals=torch.from_numpy(normals),
        env_pyramid=EnvPyramid.pack(env, cfg.env_base),
        node_count=N,
        max_count=int(max(1, leaf_counts.max())) if leaf_counts.size else 1,
    )
