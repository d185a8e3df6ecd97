"""Flatten a built BVH into node arrays indexed in DFS in-order
(negative subtree, self, positive subtree — reference
world.cpp:145-210), with the 8 banks of stackless hit/miss links, one
per ray-direction octant (create_hitmiss, world.cpp:215-278).  The
8-wide collapse (ops/pack_wide.py) reads ``children``; the binary
stackless walk (ops/pack.py) reads ``hitmiss``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from shader_ray_tpu_torch.models.bvh import BVH

SENTINEL = -1  # traversal stop
HITMISS_DIRECTIONS = 8


@dataclass
class FlatBVH:
    boxmin: np.ndarray       # (N, 3) f32
    boxmax: np.ndarray       # (N, 3) f32
    start: np.ndarray        # (N,) i32 — leaf triangle range start (0 for branch)
    count: np.ndarray        # (N,) i32 — leaf triangle count (0 for branch)
    children: np.ndarray     # (N, 2) i32 — (negative, positive), SENTINEL for leaf
    axis: np.ndarray         # (N,) i32 — split axis, -1 for leaf
    hitmiss: np.ndarray      # (8, N, 2) i32 — per-octant (hit_next, miss_next)
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


def create_hitmiss(bvh: BVH, perm: np.ndarray, dircode: int) -> np.ndarray:
    """One octant's (hit_next, miss_next) bank, (N, 2) int32 in DFS node
    numbering.  ``dircode`` bits: 1 = +x, 2 = +y, 4 = +z
    (world.cpp:215-217).  A ray moving toward -axis enters the positive
    (greater-coordinate) child first (world.cpp:263-269).  A leaf's two
    links are equal: the node after it in the walk."""
    out = np.full((bvh.node_count, 2), SENTINEL, dtype=np.int32)
    sign = [1.0 if dircode & (1 << a) else -1.0 for a in range(3)]
    stack: list[int] = []
    g = bvh.root
    while g != -1:
        miss = stack[-1] if stack else -1
        node = bvh.nodes[g]
        gi = int(perm[g])
        if node.is_leaf:
            out[gi, 0] = perm[miss] if miss != -1 else SENTINEL
            out[gi, 1] = out[gi, 0]
            g = stack.pop() if stack else -1
        else:
            if sign[node.axis] < 0:
                near, far = node.positive, node.negative
            else:
                near, far = node.negative, node.positive
            out[gi, 0] = perm[near]
            out[gi, 1] = perm[miss] if miss != -1 else SENTINEL
            if len(stack) >= 64:
                raise ValueError("hitmiss stack overflow (world.cpp:273)")
            stack.append(far)
            g = near
    return out


def flatten_bvh(bvh: BVH) -> FlatBVH:
    n = bvh.node_count
    perm = generate_group_indices(bvh)
    boxmin = np.zeros((n, 3), np.float32)
    boxmax = np.zeros((n, 3), np.float32)
    start = np.zeros(n, np.int32)
    count = np.zeros(n, np.int32)
    children = np.full((n, 2), SENTINEL, np.int32)
    axis = np.full(n, -1, np.int32)
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
            axis[i] = node.axis
    hitmiss = np.stack(
        [create_hitmiss(bvh, perm, d) for d in range(HITMISS_DIRECTIONS)], axis=0
    )
    return FlatBVH(
        boxmin=boxmin, boxmax=boxmax, start=start, count=count,
        children=children, axis=axis, hitmiss=hitmiss, root=int(perm[bvh.root]),
    )
