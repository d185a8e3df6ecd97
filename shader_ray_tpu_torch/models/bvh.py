"""Binned-SAH BVH construction (host side, numpy).

The reference's recursive top-down construction (bvh.cpp:288-358) with its
defaults:

* leaf when depth >= bvh_max_depth or count <= bvh_leaf_max
  (bvh.cpp:28,32,300-302);
* split axis = widest extent of the barycenter box, the only axis
  scanned (bvh.cpp:312-327);
* binned SAH with min(40, 2*count) bins over the vertex box extent,
  triangles binned by barycenter (bvh.cpp:200-246);
* SAH cost ctrav + cisec * sum(area_i/area * n_i) (bvh.cpp:106-120);
* no split beats the leaf cost, or all triangles on one side -> leaf
  (bvh.cpp:329-332, 351-355);
* stable partition by barycenter vs. the split plane (bvh.cpp:249-286).

Node order, split choices and the triangle permutation are the
reference package's numpy construction's, byte for byte.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from shader_ray_tpu_torch.config import Config

MAX_BIN_COUNT = 40  # bvh.cpp:200
LEAF_MAX_SIZE_FOR_STATS = 64  # bvh.cpp:44


@dataclass
class BVHNode:
    """One node (reference group.h:22-40); children index BVH.nodes,
    -1 for leaves."""

    boxmin: np.ndarray
    boxmax: np.ndarray
    negative: int = -1
    positive: int = -1
    start: int = 0
    count: int = 0
    axis: int = -1  # split axis, -1 for leaves

    @property
    def is_leaf(self) -> bool:
        return self.negative < 0


@dataclass
class BVHStats:
    """Node and leaf counts of a build (reference print_bvh_stats,
    bvh.cpp:83-99); the SBVH builder (models/sbvh.py) fills them."""

    node_count: int = 0
    leaf_count: int = 0
    nodes_by_level: dict = field(default_factory=dict)
    leaves_by_size: dict = field(default_factory=dict)
    leaf_count_ge_max_size: int = 0
    large_leaf_no_split: int = 0
    large_leaf_one_side: int = 0

    def print(self, file=sys.stderr) -> None:
        print(f"{self.node_count} bvh nodes", file=file)
        print(f"{self.leaf_count} of those are leaves", file=file)
        for level in sorted(self.nodes_by_level):
            print(f"bvh level {level:2d}: {self.nodes_by_level[level]:6d} nodes", file=file)
        for size in sorted(self.leaves_by_size):
            print(f"{size:2d} shapes in {self.leaves_by_size[size]:6d} leaves", file=file)
        if self.leaf_count_ge_max_size > 0:
            print(f"{LEAF_MAX_SIZE_FOR_STATS} or more objects in "
                  f"{self.leaf_count_ge_max_size:6d} leaves", file=file)


@dataclass
class BVH:
    """Node list + the triangle reference order it indexes: ``order[k]``
    is the original index of the triangle that leaf ranges see at k.
    ``make_bvh`` gives a permutation; the SBVH build may list a triangle
    more than once (len(order) = R >= T)."""

    nodes: list[BVHNode]
    root: int
    order: np.ndarray
    stats: BVHStats | None = None

    @property
    def node_count(self) -> int:
        return len(self.nodes)


def _surface_area(dim: np.ndarray) -> np.ndarray:
    """2*(xy+xz+yz) (bvh.cpp:101-104); works on (..., 3)."""
    x, y, z = dim[..., 0], dim[..., 1], dim[..., 2]
    return 2.0 * (x * y + x * z + y * z)


def _leaf_cost(count: int, cfg: Config) -> float:
    return cfg.sah_ctrav + cfg.sah_cisec * count  # bvh.cpp:107-110


def make_bvh(
    tri_boxmin: np.ndarray,
    tri_boxmax: np.ndarray,
    barycenters: np.ndarray,
    config: Config | None = None,
) -> BVH:
    cfg = config or Config()
    T = int(barycenters.shape[0])
    order = np.arange(T, dtype=np.int32)
    bmin = np.asarray(tri_boxmin, dtype=np.float32).copy()
    bmax = np.asarray(tri_boxmax, dtype=np.float32).copy()
    bary = np.asarray(barycenters, dtype=np.float32).copy()
    nodes: list[BVHNode] = []

    def make_leaf(start: int, count: int) -> int:
        lo = bmin[start : start + count].min(axis=0) if count else np.full(3, np.finfo(np.float32).max)
        hi = bmax[start : start + count].max(axis=0) if count else np.full(3, -np.finfo(np.float32).max)
        nodes.append(BVHNode(boxmin=lo, boxmax=hi, start=start, count=count))
        return len(nodes) - 1

    def build(start: int, count: int, level: int) -> int:
        if level >= cfg.bvh_max_depth or count <= cfg.bvh_leaf_max:
            return make_leaf(start, count)

        sl = slice(start, start + count)
        vertexbox_min = bmin[sl].min(axis=0)
        vertexbox_max = bmax[sl].max(axis=0)
        barydim = np.maximum(0.0, bary[sl].max(axis=0) - bary[sl].min(axis=0))
        if barydim[0] > barydim[1] and barydim[0] > barydim[2]:
            axis = 0
        elif barydim[1] > barydim[2]:
            axis = 1
        else:
            axis = 2

        bin_count = min(MAX_BIN_COUNT, count * 2)
        lo = float(vertexbox_min[axis])
        hi = float(vertexbox_max[axis])
        x = bary[sl, axis]

        split_x = None
        if hi > lo:
            bins = np.floor((x - lo) * bin_count / (hi - lo)).astype(np.int64)
            bins = np.clip(bins, 0, bin_count - 1)
            bin_counts = np.bincount(bins, minlength=bin_count)
            INF = np.float32(np.finfo(np.float32).max)
            bin_min = np.full((bin_count, 3), INF, np.float32)
            bin_max = np.full((bin_count, 3), -INF, np.float32)
            for d in range(3):
                np.minimum.at(bin_min[:, d], bins, bmin[sl, d])
                np.maximum.at(bin_max[:, d], bins, bmax[sl, d])
            # suffix scan: right boxes/counts; prefix scan: left boxes
            # (leftbox at split i covers bins [0, i))
            right_min = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            right_max = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            right_cnt = np.cumsum(bin_counts[::-1])[::-1]
            left_min = np.minimum.accumulate(bin_min, axis=0)
            left_max = np.maximum.accumulate(bin_max, axis=0)

            area = _surface_area(np.maximum(0.0, vertexbox_max - vertexbox_min))
            best = _leaf_cost(count, cfg)
            for i in range(1, bin_count):
                rtri = int(right_cnt[i])
                ltri = count - rtri
                if rtri == 0 or ltri == 0:
                    continue
                ldim = np.maximum(0.0, left_max[i - 1] - left_min[i - 1])
                rdim = np.maximum(0.0, right_max[i] - right_min[i])
                cost = cfg.sah_ctrav + cfg.sah_cisec * (
                    _surface_area(ldim) / area * ltri + _surface_area(rdim) / area * rtri
                )
                if cost < best:
                    best = cost
                    split_x = lo + i * (hi - lo) / bin_count  # bvh.cpp:187

        if split_x is None:
            return make_leaf(start, count)
        neg_mask = x < split_x
        countA = int(neg_mask.sum())
        countB = count - countA
        if countA == 0 or countB == 0:
            return make_leaf(start, count)

        perm = np.concatenate([np.nonzero(neg_mask)[0], np.nonzero(~neg_mask)[0]]) + start
        order[sl] = order[perm]
        bmin[sl] = bmin[perm]
        bmax[sl] = bmax[perm]
        bary[sl] = bary[perm]

        neg = build(start, countA, level + 1)
        pos = build(start + countA, countB, level + 1)
        nodes.append(
            BVHNode(boxmin=vertexbox_min, boxmax=vertexbox_max, negative=neg, positive=pos,
                    axis=axis)
        )
        return len(nodes) - 1

    root = make_leaf(0, 0) if T == 0 else build(0, T, 0)
    return BVH(nodes=nodes, root=root, order=order)
