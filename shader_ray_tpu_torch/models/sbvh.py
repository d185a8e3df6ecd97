"""SBVH spatial-split builder (host side, numpy; counterpart of
shader_ray_tpu/models/sbvh.py, node for node).

Stich et al. 2009, "Spatial Splits in Bounding Volume Hierarchies", on
the binary-BVH contract of models/bvh.py (nodes + a leaf-ordered
triangle reference array).  Unlike ``make_bvh`` (the reference's
object-split builder, bvh.cpp:288-358), a spatial split may DUPLICATE a
triangle reference into both children, each copy's AABB clipped to its
side of the plane, so long triangles stop stretching child bounds at the
price of a bounded increase of the reference count.  Downstream layers
read leaves as (start, count) ranges over the reference order
(world.get_shader_data gathers a triangle row per reference), so the
flatten, the packs and the kernels take R >= T references as they take
T; a hit id is a reference index.  Closest-hit and any-hit results are
unchanged: every part of a triangle is covered by the leaves whose
regions it overlaps, and a hit accepted outside the current leaf's box
is still a real intersection that the closest-hit test keeps.

Not the default build; ``Config.splits = "sbvh"`` (SRT_SPLITS=sbvh)
selects it.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.bvh import BVH, BVHNode, BVHStats, _leaf_cost, _surface_area
from shader_ray_tpu_torch.models.triangle_set import BUMPOUT

SPATIAL_BINS = 32
# spatial splits are only evaluated when the best object split's child
# boxes overlap by more than ALPHA of the root surface area (Stich
# section 4.4: the restriction keeps build time near object-only SAH)
ALPHA = 1e-5
# reference-duplication budget: spatial splitting stops once the total
# reference count exceeds this multiple of the triangle count
REF_BUDGET = 1.5


def _sa(ext: np.ndarray) -> float:
    return float(_surface_area(np.maximum(0.0, ext)))


def _clip_tri_plane(V: np.ndarray, axis: int, x: float):
    """Clip triangles against the plane ``p[axis] == x``.

    V: (S, 3, 3) vertex positions of triangles known to straddle the
    plane.  Returns (lmin, lmax, rmin, rmax): AABBs of each triangle's
    polygon part on the negative/positive side.  Vertices exactly on
    the plane belong to both sides.
    """
    S = V.shape[0]
    d = V[:, :, axis] - np.float32(x)  # (S, 3) signed distances
    INF = np.float32(np.finfo(np.float32).max)

    lmin = np.full((S, 3), INF, np.float32)
    lmax = np.full((S, 3), -INF, np.float32)
    rmin = np.full((S, 3), INF, np.float32)
    rmax = np.full((S, 3), -INF, np.float32)

    def _accum(points: np.ndarray, mask: np.ndarray, side: str) -> None:
        # points: (S, 3); mask: (S,) — fold masked rows into the AABBs
        big = np.where(mask[:, None], points, INF)
        small = np.where(mask[:, None], points, -INF)
        if side == "l":
            np.minimum(lmin, big, out=lmin)
            np.maximum(lmax, small, out=lmax)
        else:
            np.minimum(rmin, big, out=rmin)
            np.maximum(rmax, small, out=rmax)

    for i in range(3):
        _accum(V[:, i, :], d[:, i] <= 0.0, "l")
        _accum(V[:, i, :], d[:, i] >= 0.0, "r")
    for i, j in ((0, 1), (1, 2), (2, 0)):
        cross = (d[:, i] * d[:, j]) < 0.0  # strict sign change
        denom = d[:, i] - d[:, j]
        t = np.where(cross, d[:, i] / np.where(denom == 0.0, 1.0, denom), 0.0)
        P = V[:, i, :] + t[:, None] * (V[:, j, :] - V[:, i, :])
        P[:, axis] = x  # exact plane coordinate, immune to f32 drift
        _accum(P, cross, "l")
        _accum(P, cross, "r")

    # the plane coordinate bounds each side exactly
    lmax[:, axis] = np.minimum(lmax[:, axis], x)
    rmin[:, axis] = np.maximum(rmin[:, axis], x)
    return lmin, lmax, rmin, rmax


def make_sbvh(
    verts: np.ndarray,
    config: Config | None = None,
    verbose: bool = False,
    alpha: float = ALPHA,
    ref_budget: float = REF_BUDGET,
) -> BVH:
    """Build an SBVH over ``verts`` (T, 3, 3) triangle positions.

    Returns a ``BVH`` whose ``order`` is the concatenated per-leaf
    reference list — length R >= T, with duplicates where spatial
    splits divided a triangle.  Same node structure, flattening, and
    leaf-range semantics as ``make_bvh``.
    """
    cfg = config or Config()
    verts = np.asarray(verts, np.float32)
    T = int(verts.shape[0])
    stats = BVHStats()
    nodes: list[BVHNode] = []
    order_parts: list[np.ndarray] = []
    state = {"order_len": 0, "total_refs": T, "spatial_splits": 0, "dup_refs": 0}
    max_refs = int(T * ref_budget) + cfg.bvh_leaf_max + 1

    if T == 0:
        lo = np.full(3, np.finfo(np.float32).max)
        hi = np.full(3, -np.finfo(np.float32).max)
        nodes.append(BVHNode(boxmin=lo, boxmax=hi, start=0, count=0))
        stats.leaf_count = stats.node_count = 1
        stats.nodes_by_level[0] = 1
        return BVH(nodes, 0, np.zeros(0, np.int32), stats)

    root_min = verts.min(axis=(0, 1))
    root_max = verts.max(axis=(0, 1))
    sa_root = max(_sa(root_max - root_min), 1e-30)

    def make_leaf(tri, rmin, rmax, level):
        count = len(tri)
        lo = rmin.min(axis=0)
        hi = rmax.max(axis=0)
        start = state["order_len"]
        order_parts.append(tri.astype(np.int32))
        state["order_len"] += count
        nodes.append(BVHNode(boxmin=lo, boxmax=hi, start=start, count=count))
        stats.leaf_count += 1
        stats.node_count += 1
        stats.nodes_by_level[level] = stats.nodes_by_level.get(level, 0) + 1
        stats.leaves_by_size[count] = stats.leaves_by_size.get(count, 0) + 1
        return len(nodes) - 1

    def _object_candidates(tri, rmin, rmax, count, area):
        """Best binned-SAH object split over all 3 centroid axes.
        Returns (cost, axis, split_x, overlap_sa) or None."""
        cent = 0.5 * (rmin + rmax)
        clo = cent.min(axis=0)
        chi = cent.max(axis=0)
        best = None
        nb = min(SPATIAL_BINS, 2 * count)
        INF = np.float32(np.finfo(np.float32).max)
        for a in range(3):
            lo, hi = float(clo[a]), float(chi[a])
            if hi <= lo:
                continue
            bins = np.clip(
                ((cent[:, a] - lo) * nb / (hi - lo)).astype(np.int64), 0, nb - 1
            )
            cnt = np.bincount(bins, minlength=nb)
            bin_min = np.full((nb, 3), INF, np.float32)
            bin_max = np.full((nb, 3), -INF, np.float32)
            for d in range(3):
                np.minimum.at(bin_min[:, d], bins, rmin[:, d])
                np.maximum.at(bin_max[:, d], bins, rmax[:, d])
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmins = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmaxs = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            rcnt = np.cumsum(cnt[::-1])[::-1]
            for i in range(1, nb):
                nr = int(rcnt[i])
                nl = count - nr
                if nl == 0 or nr == 0:
                    continue
                cost = cfg.sah_ctrav + cfg.sah_cisec * (
                    _sa(lmax[i - 1] - lmin[i - 1]) / area * nl
                    + _sa(rmaxs[i] - rmins[i]) / area * nr
                )
                if best is None or cost < best[0]:
                    omin = np.maximum(lmin[i - 1], rmins[i])
                    omax = np.minimum(lmax[i - 1], rmaxs[i])
                    best = (
                        cost, a, lo + i * (hi - lo) / nb,
                        _sa(omax - omin) if (omin <= omax).all() else 0.0,
                    )
        return best

    def _spatial_candidates(tri, rmin, rmax, count, area, nmin, nmax):
        """Best chopped-binning spatial split over all 3 node-box axes.
        Returns (cost, axis, plane_x) or None."""
        best = None
        INF = np.float32(np.finfo(np.float32).max)
        for a in range(3):
            lo, hi = float(nmin[a]), float(nmax[a])
            if hi <= lo:
                continue
            w = (hi - lo) / SPATIAL_BINS
            b_in = np.clip(
                ((rmin[:, a] - lo) / w).astype(np.int64), 0, SPATIAL_BINS - 1
            )
            b_out = np.clip(
                ((rmax[:, a] - lo) / w).astype(np.int64), 0, SPATIAL_BINS - 1
            )
            entry = np.bincount(b_in, minlength=SPATIAL_BINS)
            exit_ = np.bincount(b_out, minlength=SPATIAL_BINS)
            bin_min = np.full((SPATIAL_BINS, 3), INF, np.float32)
            bin_max = np.full((SPATIAL_BINS, 3), -INF, np.float32)
            # scatter each ref into every bin of its span (offset loop:
            # iteration count = the WIDEST span, work per iteration =
            # refs still spanning — small triangles cost one pass).
            # Chopped extent: exact on the split axis, the ref's
            # clipped-box extent elsewhere (conservative SAH).
            span = b_out - b_in
            for k in range(int(span.max()) + 1):
                m = span >= k
                if not m.any():
                    break
                j = b_in[m] + k
                mn = rmin[m].copy()
                mx = rmax[m].copy()
                blo = (lo + j * w).astype(np.float32)
                mn[:, a] = np.maximum(mn[:, a], blo)
                mx[:, a] = np.minimum(mx[:, a], blo + np.float32(w))
                for d in range(3):
                    np.minimum.at(bin_min[:, d], j, mn[:, d])
                    np.maximum.at(bin_max[:, d], j, mx[:, d])
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmins = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmaxs = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            nl_cum = np.cumsum(entry)
            nr_cum = np.cumsum(exit_[::-1])[::-1]
            for i in range(1, SPATIAL_BINS):
                nl = int(nl_cum[i - 1])   # refs entering before plane i
                nr = int(nr_cum[i])       # refs exiting at/after plane i
                if nl == 0 or nr == 0:
                    continue
                cost = cfg.sah_ctrav + cfg.sah_cisec * (
                    _sa(lmax[i - 1] - lmin[i - 1]) / area * nl
                    + _sa(rmaxs[i] - rmins[i]) / area * nr
                )
                if best is None or cost < best[0]:
                    best = (cost, a, lo + i * w)
        return best

    t_start = time.monotonic()
    last_progress = [t_start]

    def build(tri, rmin, rmax, level):
        count = len(tri)
        if verbose:
            now = time.monotonic()
            if now - last_progress[0] > 1.0:
                print(
                    f"sbvh: {state['order_len']} refs emitted,"
                    f" {state['total_refs']} total",
                    file=sys.stderr,
                )
                last_progress[0] = now
        if level >= cfg.bvh_max_depth or count <= cfg.bvh_leaf_max:
            return make_leaf(tri, rmin, rmax, level)

        nmin = rmin.min(axis=0)
        nmax = rmax.max(axis=0)
        area = max(_sa(nmax - nmin), 1e-30)
        leaf_cost = _leaf_cost(count, cfg)

        obj = _object_candidates(tri, rmin, rmax, count, area)
        plan = None  # ("obj"|"sp", cost, axis, x)
        if obj is not None and obj[0] < leaf_cost:
            plan = ("obj", obj[0], obj[1], obj[2])
        overlap_frac = (obj[3] / sa_root) if obj is not None else 1.0
        if overlap_frac > alpha and state["total_refs"] <= max_refs:
            sp = _spatial_candidates(tri, rmin, rmax, count, area, nmin, nmax)
            if sp is not None and sp[0] < leaf_cost and (
                plan is None or sp[0] < plan[1]
            ):
                plan = ("sp", sp[0], sp[1], sp[2])

        if plan is None:
            stats.large_leaf_no_split += 1
            return make_leaf(tri, rmin, rmax, level)

        kind, _, a, x = plan
        if kind == "obj":
            cent_a = 0.5 * (rmin[:, a] + rmax[:, a])
            neg = cent_a < x
            if not neg.any() or neg.all():
                stats.large_leaf_one_side += 1
                return make_leaf(tri, rmin, rmax, level)
            lt, lmn, lmx = tri[neg], rmin[neg], rmax[neg]
            rt, rmn, rmx = tri[~neg], rmin[~neg], rmax[~neg]
        else:
            left_only = rmax[:, a] <= x
            # a ref exactly ON the plane (degenerate extent) matches
            # both predicates — send it left only, once
            right_only = (rmin[:, a] >= x) & ~left_only
            strad = ~(left_only | right_only)
            s_idx = np.nonzero(strad)[0]
            if s_idx.size:
                V = verts[tri[s_idx]]
                clmin, clmax, crmin, crmax = _clip_tri_plane(V, a, float(x))
                # BUMPOUT every clipped box (vectormath.h:191, the same
                # padding TriangleSet applies to whole-triangle boxes):
                # planar geometry otherwise yields ZERO-thickness leaf
                # boxes, which the reference's strict t0 < t1 slab test
                # (fs:403) can never enter
                clmin -= BUMPOUT
                clmax += BUMPOUT
                crmin -= BUMPOUT
                crmax += BUMPOUT
                # respect ancestor clips: intersect with the current box
                clmin = np.maximum(clmin, rmin[s_idx])
                clmax = np.minimum(clmax, rmax[s_idx])
                crmin = np.maximum(crmin, rmin[s_idx])
                crmax = np.minimum(crmax, rmax[s_idx])
                lvalid = (clmin <= clmax).all(axis=1)
                rvalid = (crmin <= crmax).all(axis=1)
                # a straddler must land somewhere: degenerate clips
                # (ancestor box cut the part off) fall back whole-ref
                neither = ~(lvalid | rvalid)
                if neither.any():
                    lvalid = lvalid | neither
                    clmin[neither] = rmin[s_idx][neither]
                    clmax[neither] = rmax[s_idx][neither]
                dup = int((lvalid & rvalid).sum())
            else:
                lvalid = rvalid = np.zeros(0, bool)
                clmin = clmax = crmin = crmax = np.zeros((0, 3), np.float32)
                dup = 0
            lt = np.concatenate([tri[left_only], tri[s_idx][lvalid]])
            lmn = np.concatenate([rmin[left_only], clmin[lvalid]])
            lmx = np.concatenate([rmax[left_only], clmax[lvalid]])
            rt = np.concatenate([tri[right_only], tri[s_idx][rvalid]])
            rmn = np.concatenate([rmin[right_only], crmin[rvalid]])
            rmx = np.concatenate([rmax[right_only], crmax[rvalid]])
            if len(lt) == 0 or len(rt) == 0 or len(lt) == count or len(rt) == count:
                stats.large_leaf_one_side += 1
                return make_leaf(tri, rmin, rmax, level)
            state["total_refs"] += dup
            state["dup_refs"] += dup
            state["spatial_splits"] += 1

        neg_i = build(lt, lmn, lmx, level + 1)
        pos_i = build(rt, rmn, rmx, level + 1)
        nodes.append(
            BVHNode(boxmin=nmin, boxmax=nmax, axis=a, negative=neg_i, positive=pos_i)
        )
        stats.node_count += 1
        stats.nodes_by_level[level] = stats.nodes_by_level.get(level, 0) + 1
        return len(nodes) - 1

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
    # whole-triangle ref boxes carry the reference's BUMPOUT padding
    # exactly like TriangleSet.finish (vectormath.h:191) — degenerate
    # planar boxes never intersect the strict t0 < t1 slab test
    ref_min = verts.min(axis=1) - BUMPOUT
    ref_max = verts.max(axis=1) + BUMPOUT
    root = build(np.arange(T, dtype=np.int32), ref_min, ref_max, 0)
    order = (
        np.concatenate(order_parts) if order_parts else np.zeros(0, np.int32)
    )
    if verbose:
        dt = time.monotonic() - t_start
        print(
            f"sbvh: {len(order)} refs for {T} tris "
            f"({len(order) / max(T, 1):.3f}x), "
            f"{state['spatial_splits']} spatial splits, {dt:.2f}s",
            file=sys.stderr,
        )
        stats.print()
    return BVH(nodes=nodes, root=root, order=order, stats=stats)
