"""Host-side 8-wide BVH pack for per-thread traversal (counterpart of
shader_ray_tpu/ops/pallas/pack_wide.py with pack.py's leaf records,
Woop or Moller-Trumbore).

The binary SAH tree is collapsed into 8-wide nodes by the same SAH
dynamic program (``_collapse_sah``) or, with ``Config.collapse =
"greedy"``, the same largest-area greedy cut (``_collapse_greedy``), with
the same per-octant near-to-far child orders and stack bound, so both
packages walk the same wide tree.  The layout is the one a thread walking one ray wants,
read with 16-byte loads:

  nodes   (Nw, 8, 8) f32      child k of a node as two float4s:
                              (lo.x, lo.y, lo.z, meta) and (hi.x, hi.y,
                              hi.z, order of octant k); meta and order
                              are int32 bits.  Boxes are exact f32 (the
                              16-bit quantisation existed for the TPU's
                              scalar memory).  Meta: leaf count<<26 |
                              first triangle; internal: wide node index;
                              empty: -1.  Order: the octant's child order,
                              8 x 3-bit slots, nearest first (empties
                              last).  256 bytes a node.
  leaves  (T, 12) f32         each triangle's test rows as three float4s,
                              in BVH order (the row index is the triangle
                              id), in the form ``Config.leaf_isect`` names
                              (``PackedWide.isect``): "woop" the test rows
                              of its Woop record (floats 0-11 of
                              WOOP_RECORD: the distance, u and v rows);
                              "mt" v0, e0 = v1 - v0 and e1 = v0 - v2, each
                              padded with a zero, the Moller-Trumbore
                              operands rounded as the test forms them
                              from v0 v1 v2 (kernel_body.slot_hit)
  normals (T, 12) f32         n0, n1 - n0, n2 - n0 in f32 (the rest of the
                              Woop record, floats 12-20; the same in both
                              forms), padded with zeros to three float4s,
                              read once a ray after its walk

``PackedWide.child_boxes``, ``child_meta`` and ``orders`` read the node
table back per child.

Leaf counts are capped at ``max_leaf_tests`` (the reference's
10-triangle leaf budget, raytracer.es.fs:382).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.world import SceneData
from shader_ray_tpu_torch.ops.envmap import EnvPyramid

WIDE = 8            # children per wide node
TINY_LEAF_MAX = 4   # leaf size classes of the collapse cost model
SMALL_LEAF_MAX = 7  # (the reference kernel's static unroll lengths)
COUNT_SHIFT = 26    # child meta: count << 26 | first triangle
FIRST_MASK = (1 << COUNT_SHIFT) - 1

# Woop record, 21 f32 per triangle (pack.WOOP_LEAF_RECORD):
#   0-2   N = (v1-v0) x (v2-v0)  (unscaled: N.D == -det_MT, so the eps
#   3     -N.v0                   accept test matches Moller-Trumbore)
#   4-6   r0 = (E2 x N) / |N|^2  (u row of the inverse basis)
#   7     -r0.v0
#   8-10  r1 = (N x E1) / |N|^2  (v row)
#   11    -r1.v0
#   12-20 n0.xyz (n1-n0).xyz (n2-n0).xyz
WOOP_RECORD = 21
LEAF_STRIDE = 12    # floats a triangle takes in the leaf table, and in the normal table
ISECTS = ("woop", "mt")  # leaf test forms (Config.leaf_isect), by the kernels' code


@dataclass
class PackedWide:
    nodes: torch.Tensor       # (Nw, 8, 8) f32 (meta and orders as int32 bits)
    leaves: torch.Tensor      # (T, 12) f32 test rows of the form ``isect``
    normals: torch.Tensor     # (T, 12) f32 normal terms
    env_pyramid: EnvPyramid   # level 0 (the frame kernel's env) + mips
    n_wide: int
    stack_depth: int
    max_count: int            # largest leaf count after the cap
    isect: str = "woop"       # the leaf test the rows are for (ISECTS)

    @property
    def child_boxes(self) -> torch.Tensor:
        """(Nw, 8, 6) f32 child boxes lo.xyz, hi.xyz."""
        return torch.cat([self.nodes[..., 0:3], self.nodes[..., 4:7]], dim=-1)

    @property
    def child_meta(self) -> torch.Tensor:
        """(Nw, 8) i32 child meta, a view of the node table."""
        return self.nodes.view(torch.int32)[..., 3]

    @property
    def orders(self) -> torch.Tensor:
        """(Nw, 8) i32 child order of each octant, a view of the node table."""
        return self.nodes.view(torch.int32)[..., 7]

    @property
    def env(self) -> torch.Tensor:
        """(H0, W0, TEXEL) f32 env level 0 (RGB and a zero pad), a view of
        the pyramid."""
        return self.env_pyramid.level0

    def to(self, device) -> "PackedWide":
        return PackedWide(
            nodes=self.nodes.to(device),
            leaves=self.leaves.to(device),
            normals=self.normals.to(device),
            env_pyramid=self.env_pyramid.to(device),
            n_wide=self.n_wide,
            stack_depth=self.stack_depth,
            max_count=self.max_count,
            isect=self.isect,
        )


def mt_rows(pos: np.ndarray) -> np.ndarray:
    """(T, 9) v0v1v2 positions -> (T, 12) Moller-Trumbore test rows v0,
    v1 - v0, v0 - v2, each padded with a zero (f32 differences, as
    kernel_body.slot_hit forms them from the raw vertex lanes)."""
    p = pos.astype(np.float32)
    v0, v1, v2 = p[:, 0:3], p[:, 3:6], p[:, 6:9]
    rows = np.zeros((len(p), LEAF_STRIDE), np.float32)
    for j, x in enumerate((v0, v1 - v0, v0 - v2)):
        rows[:, 4 * j:4 * j + 3] = x
    return rows


def woop_records(pos: np.ndarray, nrm: np.ndarray) -> np.ndarray:
    """(T, 9) v0v1v2 positions + (T, 9) n0n1n2 normals -> (T, 21)
    Woop records (f64 host math, pack.py:132-156)."""
    p = pos.astype(np.float64)
    v0, v1, v2 = p[:, 0:3], p[:, 3:6], p[:, 6:9]
    e1 = v1 - v0
    e2 = v2 - v0
    N = np.cross(e1, e2)
    det = np.einsum("ij,ij->i", N, N)  # |N|^2
    inv = np.where(det > 0.0, 1.0 / np.maximum(det, 1e-300), 0.0)[:, None]
    r0 = np.cross(e2, N) * inv
    r1 = np.cross(N, e1) * inv
    rec = np.zeros((len(p), WOOP_RECORD), np.float32)
    rec[:, 0:3] = N
    rec[:, 3] = -np.einsum("ij,ij->i", N, v0)
    rec[:, 4:7] = r0
    rec[:, 7] = -np.einsum("ij,ij->i", r0, v0)
    rec[:, 8:11] = r1
    rec[:, 11] = -np.einsum("ij,ij->i", r1, v0)
    nn = nrm.astype(np.float32)
    rec[:, 12:15] = nn[:, 0:3]
    rec[:, 15:18] = nn[:, 3:6] - nn[:, 0:3]
    rec[:, 18:21] = nn[:, 6:9] - nn[:, 0:3]
    return rec


def _collapse_sah(data: SceneData, c_node: float = 1.0,
                  c_leaf_fixed: float = 0.8, c_slot: float = 0.45):
    """SAH-aware 8-wide collapse (dynamic program over the binary tree,
    after Ylitie et al. 2017): C(n, i) = least cost of subtree(n) as a
    forest of <= i wide-node child slots; cutting an internal node costs
    area(n) * c_node, a leaf child area(n) * (c_leaf_fixed + c_slot *
    unroll(count)).  The same cost model and tie order as the reference
    packer, so both packages build the same wide tree.

    Returns (wide_children, wid_of_binary, depth_of, is_leaf):
    wide_children[w] = binary node ids of wide node w's child slots."""
    children = data.node_children
    count = data.node_objects[:, 1]
    bmin = data.node_boxes[:, 0:3].astype(np.float64)
    bmax = data.node_boxes[:, 3:6].astype(np.float64)
    ext = np.maximum(bmax - bmin, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    root = int(data.tree_root)
    if area[root] > 0:
        area = area / area[root]
    is_leaf = count > 0

    def unroll(c: int) -> int:
        if c <= TINY_LEAF_MAX:
            return TINY_LEAF_MAX
        if c <= SMALL_LEAF_MAX:
            return SMALL_LEAF_MAX
        return max(int(count.max()), SMALL_LEAF_MAX + 1)

    n = data.group_count
    INF = float("inf")
    # C[b, i-1]: best cost of subtree(b) as <= i roots; K[b, i-1]: 0 =>
    # keep b as one root, k > 0 => k slots left, i-k right
    C = np.full((n, WIDE), INF)
    K = np.zeros((n, WIDE), np.int16)

    order: list[int] = []
    stack = [root]
    seen = np.zeros(n, bool)
    while stack:
        b = stack.pop()
        if seen[b]:
            continue
        seen[b] = True
        order.append(b)
        if not is_leaf[b] and children[b, 0] >= 0:
            stack.append(int(children[b, 0]))
            stack.append(int(children[b, 1]))
    for b in reversed(order):  # children before parents
        if is_leaf[b] or children[b, 0] < 0:
            C[b, :] = area[b] * (c_leaf_fixed + c_slot * unroll(int(count[b])))
            continue
        l, r = int(children[b, 0]), int(children[b, 1])
        dist = np.full(WIDE + 1, INF)
        dargk = np.zeros(WIDE + 1, np.int16)
        for i in range(2, WIDE + 1):
            for k in range(1, i):
                c = C[l, k - 1] + C[r, i - k - 1]
                if c < dist[i]:
                    dist[i] = c
                    dargk[i] = k
        c_cut = area[b] * c_node + dist[WIDE]
        C[b, 0] = c_cut
        K[b, 0] = 0
        for i in range(2, WIDE + 1):
            if dist[i] < c_cut:
                C[b, i - 1] = dist[i]
                K[b, i - 1] = dargk[i]
            else:
                C[b, i - 1] = c_cut
                K[b, i - 1] = 0

    def forest(b: int, i: int) -> list[int]:
        if is_leaf[b] or children[b, 0] < 0:
            return [int(b)]
        k = int(K[b, i - 1])
        if k == 0:
            return [int(b)]
        return forest(int(children[b, 0]), k) + forest(int(children[b, 1]), i - k)

    def node_children_of(b: int) -> list[int]:
        if is_leaf[b]:
            return [int(b)]
        if children[b, 0] < 0:
            return []
        l, r = int(children[b, 0]), int(children[b, 1])
        best, bestk = INF, 1
        for k in range(1, WIDE):
            c = C[l, k - 1] + C[r, WIDE - k - 1]
            if c < best:
                best, bestk = c, k
        return forest(l, bestk) + forest(r, WIDE - bestk)

    # BFS with FIFO ids: parents precede children, root = 0
    queue = deque([(root, 0)])
    wid_of_binary = {root: 0}
    next_id = 1
    wide_children: list[list[int]] = []
    depth_of: list[int] = []
    while queue:
        b, d = queue.popleft()
        fr = node_children_of(b)
        wide_children.append(fr)
        depth_of.append(d)
        for f in fr:
            if not is_leaf[f]:
                wid_of_binary[f] = next_id
                next_id += 1
                queue.append((f, d + 1))
    return wide_children, wid_of_binary, depth_of, is_leaf


def _collapse_greedy(data: SceneData):
    """Collapse the binary tree into wide nodes: repeatedly expand the
    largest-area internal frontier member until 8 children (the
    BVH8-style greedy cut), as the reference packer's greedy collapse.
    The same return contract as ``_collapse_sah``."""
    children = data.node_children
    count = data.node_objects[:, 1]
    bmin = data.node_boxes[:, 0:3].astype(np.float64)
    bmax = data.node_boxes[:, 3:6].astype(np.float64)
    ext = np.maximum(bmax - bmin, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    is_leaf = count > 0

    def frontier(b: int) -> list[int]:
        if is_leaf[b]:
            return [int(b)]
        if children[b, 0] < 0:  # empty scene: a branch root with no children
            return []
        fr = [int(children[b, 0]), int(children[b, 1])]
        while len(fr) < WIDE:
            best, best_a = -1, -1.0
            for i, f in enumerate(fr):
                if not is_leaf[f] and area[f] > best_a:
                    best, best_a = i, float(area[f])
            if best < 0:
                break
            f = fr.pop(best)
            fr.extend([int(children[f, 0]), int(children[f, 1])])
        return fr

    # BFS with FIFO ids: parents precede children, root = 0
    root = int(data.tree_root)
    queue = deque([(root, 0)])
    wid_of_binary = {root: 0}
    next_id = 1
    wide_children: list[list[int]] = []
    depth_of: list[int] = []
    while queue:
        b, d = queue.popleft()
        fr = frontier(b)
        wide_children.append(fr)
        depth_of.append(d)
        for f in fr:
            if not is_leaf[f]:
                wid_of_binary[f] = next_id
                next_id += 1
                queue.append((f, d + 1))
    return wide_children, wid_of_binary, depth_of, is_leaf


COLLAPSES = {"sah": _collapse_sah, "greedy": _collapse_greedy}  # by Config.collapse


def pack_scene_wide(
    data: SceneData, env: np.ndarray, config: Config | None = None
) -> PackedWide:
    """Wide node table, leaf test rows of the form ``Config.leaf_isect``,
    normal terms and the env pyramid, as CPU tensors
    (``PackedWide.to(device)`` moves them); the binary tree is collapsed
    as ``Config.collapse`` says."""
    cfg = (config or Config()).validate()
    wide_children, wid_of_binary, depth_of, is_leaf = COLLAPSES[cfg.collapse](data)
    Nw = len(wide_children)
    if Nw >= (1 << COUNT_SHIFT) or data.triangle_count > FIRST_MASK:
        raise ValueError("scene too large for the 26-bit child meta")
    counts = np.minimum(data.node_objects[:, 1], cfg.max_leaf_tests)
    starts = data.node_objects[:, 0]

    boxes = np.zeros((Nw, WIDE, 6), np.float32)
    meta = np.full((Nw, 2 * WIDE), -1, np.int64)
    centers = np.full((Nw, WIDE, 3), np.inf)
    for w, fr in enumerate(wide_children):
        for k, b in enumerate(fr):
            boxes[w, k] = data.node_boxes[b, 0:6]
            centers[w, k] = 0.5 * (
                data.node_boxes[b, 0:3].astype(np.float64)
                + data.node_boxes[b, 3:6].astype(np.float64)
            )
            if is_leaf[b]:
                meta[w, k] = (int(counts[b]) << COUNT_SHIFT) | int(starts[b])
            else:
                meta[w, k] = wid_of_binary[b]

    # per-octant near-to-far order: sort child centers projected on the
    # octant direction (bit set = D positive on that axis)
    odirs = np.array(
        [[1.0 if (o >> a) & 1 else -1.0 for a in range(3)] for o in range(8)]
    )
    filled = np.isfinite(centers[:, :, 0])
    keys = np.einsum("oa,wka->owk", odirs, np.where(filled[..., None], centers, 0.0))
    keys = np.where(filled[None, :, :], keys, np.inf)  # empties sort last
    order = np.argsort(keys, axis=2, kind="stable")    # (o, Nw, 8)
    packed_order = np.zeros((Nw, 8), np.int64)
    for p in range(WIDE):
        packed_order |= order[:, :, p].T << (3 * p)
    meta[:, WIDE:] = packed_order

    nodes = np.zeros((Nw, WIDE, 8), np.float32)
    nodes[:, :, 0:3] = boxes[:, :, 0:3]
    nodes[:, :, 4:7] = boxes[:, :, 3:6]
    bits = nodes.view(np.int32)
    bits[:, :, 3] = meta[:, :WIDE]
    bits[:, :, 7] = meta[:, WIDE:]
    if cfg.leaf_isect == "woop":
        records = woop_records(data.tri_positions, data.tri_normals)
        rows = np.ascontiguousarray(records[:, :LEAF_STRIDE])
    else:
        rows = mt_rows(data.tri_positions)
    nn = data.tri_normals.astype(np.float32)
    normals = np.zeros((len(rows), LEAF_STRIDE), np.float32)
    normals[:, 0:3] = nn[:, 0:3]
    normals[:, 3:6] = nn[:, 3:6] - nn[:, 0:3]
    normals[:, 6:9] = nn[:, 6:9] - nn[:, 0:3]
    leaf_counts = counts[is_leaf]
    return PackedWide(
        nodes=torch.from_numpy(nodes),
        leaves=torch.from_numpy(rows),
        normals=torch.from_numpy(normals),
        env_pyramid=EnvPyramid.pack(env, cfg.env_base),
        n_wide=Nw,
        # each pop pushes <= 7 net entries per level (pack_wide.py:427)
        stack_depth=(WIDE - 1) * (max(depth_of) + 1) + 8,
        max_count=int(max(1, leaf_counts.max())) if leaf_counts.size else 1,
        isect=cfg.leaf_isect,
    )
