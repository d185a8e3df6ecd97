"""Flatten a built BVH into node arrays indexed in DFS in-order
(negative subtree, self, positive subtree — reference
world.cpp:145-210).  The 8-octant hit/miss link banks the binary
stackless walk needs are not built: the port walks the 8-wide
collapse (ops/pack_wide.py), which reads ``children``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from shader_ray_tpu_torch.models.bvh import BVH

SENTINEL = -1


@dataclass
class FlatBVH:
    boxmin: np.ndarray       # (N, 3) f32
    boxmax: np.ndarray       # (N, 3) f32
    start: np.ndarray        # (N,) i32 — leaf triangle range start (0 for branch)
    count: np.ndarray        # (N,) i32 — leaf triangle count (0 for branch)
    children: np.ndarray     # (N, 2) i32 — (negative, positive), SENTINEL for leaf
    root: int

    @property
    def node_count(self) -> int:
        return int(self.boxmin.shape[0])


def generate_group_indices(bvh: BVH) -> np.ndarray:
    """DFS in-order indices (world.cpp:145-177); returns old->new map."""
    new_index = np.full(bvh.node_count, -1, dtype=np.int32)
    counter = 0
    stack: list[tuple[int, bool]] = [(bvh.root, False)]
    while stack:
        node_id, expanded = stack.pop()
        node = bvh.nodes[node_id]
        if node.is_leaf or expanded:
            new_index[node_id] = counter
            counter += 1
            continue
        stack.append((node.positive, False))
        stack.append((node_id, True))
        stack.append((node.negative, False))
    if counter != bvh.node_count:
        raise ValueError("BVH node list is not one tree (world.cpp:331)")
    return new_index


def flatten_bvh(bvh: BVH) -> FlatBVH:
    n = bvh.node_count
    perm = generate_group_indices(bvh)
    boxmin = np.zeros((n, 3), np.float32)
    boxmax = np.zeros((n, 3), np.float32)
    start = np.zeros(n, np.int32)
    count = np.zeros(n, np.int32)
    children = np.full((n, 2), SENTINEL, np.int32)
    for old_id, node in enumerate(bvh.nodes):
        i = int(perm[old_id])
        boxmin[i] = node.boxmin
        boxmax[i] = node.boxmax
        if node.is_leaf:
            start[i] = node.start
            count[i] = node.count
        else:
            children[i, 0] = perm[node.negative]
            children[i, 1] = perm[node.positive]
    return FlatBVH(
        boxmin=boxmin, boxmax=boxmax, start=start, count=count,
        children=children, root=int(perm[bvh.root]),
    )
