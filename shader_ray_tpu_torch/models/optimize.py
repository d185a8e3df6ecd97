"""Insertion-based BVH topology optimizer (Bittner et al. 2013;
counterpart of shader_ray_tpu/models/optimize.py, node for node).

A post-build pass over the binary BVH: repeatedly pick the least
efficient internal nodes (large area relative to their children), remove
each one together with its parent, and re-insert its two child subtrees
independently at the globally best sibling positions found by
branch-and-bound searches over the remaining tree.  The two freed
internal nodes re-house the two insertions, so the node count never
changes; only the topology (and so the internal boxes) does.  The
reference has no such pass; ``Config.bvh_opt = "reinsert"``
(SRT_BVH_OPT=reinsert) selects it, and the scene cache keys on it.

* Leaf contents (start, count ranges into the triangle order) are never
  touched: the triangle order, the leaf boxes and so every intersection
  are unchanged; only which internal boxes a walk tests differs.
* A pass can regress, so the best topology seen is kept: never worse
  than the input tree by the SAH cost.
* Internal split axes are recomputed as the axis of largest child-centre
  separation, negative child first: the convention flatten.create_hitmiss
  and the octant orders read.

The hot loops (box unions, refits, the branch-and-bound search) run on
Python scalars in flat lists: per-element numpy indexing costs far more
than scalar float math, and a large scene runs millions of unions.
"""

from __future__ import annotations

import dataclasses
import heapq
import sys
import time

import numpy as np

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.bvh import BVH, BVHNode

# Fraction of internal nodes reinserted per pass (paper uses 1%).
BATCH_FRACTION = 0.01
MIN_BATCH = 16
MAX_PASSES = 400
# Convergence: stop when the improvement over the trailing window
# falls below REL_EPS of the current cost.
WINDOW = 10
REL_EPS = 5e-4


def optimize_bvh(
    bvh: BVH, config: Config | None = None, verbose: bool = False
) -> BVH:
    """Return a new BVH with the same leaves but reinsertion-optimized
    topology.  No-op (returns ``bvh`` unchanged) for trees with fewer
    than 4 internal nodes."""
    cfg = config or Config()
    nodes = bvh.nodes
    N = len(nodes)

    left = [-1] * N
    right = [-1] * N
    parent = [-1] * N
    # box coords as flat scalar lists (see module docstring)
    x0 = [0.0] * N; y0 = [0.0] * N; z0 = [0.0] * N
    x1 = [0.0] * N; y1 = [0.0] * N; z1 = [0.0] * N
    area = [0.0] * N
    count = [0] * N
    start = [0] * N
    n_internal = 0
    for i, nd in enumerate(nodes):
        bn, bx = nd.boxmin, nd.boxmax
        x0[i], y0[i], z0[i] = float(bn[0]), float(bn[1]), float(bn[2])
        x1[i], y1[i], z1[i] = float(bx[0]), float(bx[1]), float(bx[2])
        dx = max(0.0, x1[i] - x0[i])
        dy = max(0.0, y1[i] - y0[i])
        dz = max(0.0, z1[i] - z0[i])
        area[i] = 2.0 * (dx * dy + dx * dz + dy * dz)
        if nd.is_leaf:
            start[i], count[i] = nd.start, nd.count
        else:
            left[i], right[i] = nd.negative, nd.positive
            n_internal += 1
    if n_internal < 4:
        return bvh
    for i in range(N):
        if left[i] >= 0:
            parent[left[i]] = i
            parent[right[i]] = i
    root = int(bvh.root)

    def refit_up(i: int) -> None:
        while i >= 0:
            l, r = left[i], right[i]
            nx0 = x0[l] if x0[l] < x0[r] else x0[r]
            ny0 = y0[l] if y0[l] < y0[r] else y0[r]
            nz0 = z0[l] if z0[l] < z0[r] else z0[r]
            nx1 = x1[l] if x1[l] > x1[r] else x1[r]
            ny1 = y1[l] if y1[l] > y1[r] else y1[r]
            nz1 = z1[l] if z1[l] > z1[r] else z1[r]
            x0[i], y0[i], z0[i], x1[i], y1[i], z1[i] = nx0, ny0, nz0, nx1, ny1, nz1
            dx, dy, dz = nx1 - nx0, ny1 - ny0, nz1 - nz0
            area[i] = 2.0 * (dx * dy + dx * dz + dy * dz)
            i = parent[i]

    def sah_total() -> float:
        ct, ci = cfg.sah_ctrav, cfg.sah_cisec
        tot = 0.0
        for i in range(N):
            if left[i] >= 0:
                tot += ct * area[i]
            else:
                tot += ci * area[i] * count[i]
        return tot

    def find_best_sibling(n: int) -> int:
        """Branch-and-bound best-sibling search for inserting subtree
        ``n`` (Bittner 2013 sec. 4.3): minimize SA(n union x) plus the
        induced area growth of x's ancestors."""
        nx0, ny0, nz0 = x0[n], y0[n], z0[n]
        nx1, ny1, nz1 = x1[n], y1[n], z1[n]
        n_area = area[n]
        best_cost = float("inf")
        best_x = -1
        heap = [(0.0, root, 0.0)]
        while heap:
            bound, x, induced = heapq.heappop(heap)
            if bound >= best_cost:
                break
            ux0 = nx0 if nx0 < x0[x] else x0[x]
            uy0 = ny0 if ny0 < y0[x] else y0[x]
            uz0 = nz0 if nz0 < z0[x] else z0[x]
            ux1 = nx1 if nx1 > x1[x] else x1[x]
            uy1 = ny1 if ny1 > y1[x] else y1[x]
            uz1 = nz1 if nz1 > z1[x] else z1[x]
            dx, dy, dz = ux1 - ux0, uy1 - uy0, uz1 - uz0
            direct = 2.0 * (dx * dy + dx * dz + dy * dz)
            total = induced + direct
            if total < best_cost:
                best_cost = total
                best_x = x
            lchild = left[x]
            if lchild >= 0:
                child_induced = induced + direct - area[x]
                lb = child_induced + n_area
                if lb < best_cost:
                    # x serves as the tiebreak (unique per entry)
                    heapq.heappush(heap, (lb, lchild, child_induced))
                    heapq.heappush(heap, (lb, right[x], child_induced))
        return best_x

    def splice(sub: int, house: int) -> None:
        """Insert subtree ``sub`` at its best sibling, re-housed under
        the freed internal node ``house``."""
        x = find_best_sibling(sub)
        gx = parent[x]
        left[house], right[house] = x, sub
        parent[x] = house
        parent[sub] = house
        parent[house] = gx
        nonlocal_root = None
        if gx < 0:
            nonlocal_root = house
        else:
            if left[gx] == x:
                left[gx] = house
            else:
                right[gx] = house
        refit_up(house)
        return nonlocal_root

    t0 = time.monotonic()
    cost0 = sah_total()
    best_cost_seen = cost0
    best_snap = (list(left), list(right), root)
    history = [cost0]
    batch = max(MIN_BATCH, int(n_internal * BATCH_FRACTION))
    area_np = np.empty(N)
    for pass_i in range(MAX_PASSES):
        # selection measure M_area * M_sum * M_min (vectorized)
        area_np[:] = area
        left_np = np.array(left)
        im = left_np >= 0
        l_np = left_np[im]
        r_np = np.array(right)[im]
        a = area_np[im]
        al, ar = area_np[l_np], area_np[r_np]
        eps = 1e-30
        m = np.zeros(N)
        m[im] = a * (2.0 * a / (al + ar + eps)) * (a / (np.minimum(al, ar) + eps))
        m[root] = 0.0
        # measure-weighted random sampling (paper sec. 4.1 "combined
        # randomized"): a deterministic top-k selection reaches a fixed
        # point after ~1 pass (the same nodes reinsert to the same
        # spots forever); seeded per pass for reproducible builds
        rng = np.random.default_rng(pass_i)
        msum = m.sum()
        if msum <= 0.0:
            break
        k = min(batch * 2, int((m > 0).sum()))
        order = rng.choice(N, size=k, replace=False, p=m / msum)

        done = 0
        for n in order:
            n = int(n)
            if done >= batch:
                break
            p = parent[n]
            if left[n] < 0 or n == root or p < 0:
                continue  # leaf, root, or invalidated by an earlier move
            done += 1
            l, r = left[n], right[n]
            g = parent[p]
            s = left[p] if right[p] == n else right[p]
            # remove n AND its parent p: sibling s takes p's place; n's
            # child subtrees come free with the two internal nodes
            # (n, p) that will re-house them
            parent[s] = g
            if g < 0:
                root = s
            else:
                if left[g] == p:
                    left[g] = s
                else:
                    right[g] = s
                refit_up(g)
            parent[n] = -1
            parent[p] = -1
            pieces = (l, r) if area[l] >= area[r] else (r, l)
            for sub, house in zip(pieces, (p, n)):
                new_root = splice(sub, house)
                if new_root is not None:
                    root = new_root

        cost = sah_total()
        history.append(cost)
        if cost < best_cost_seen:
            best_cost_seen = cost
            best_snap = (list(left), list(right), root)
        if verbose and pass_i % 20 == 0:
            print(
                f"bvh-opt pass {pass_i}: SAH {cost:.5g} "
                f"({cost / cost0:.4f}x of initial)",
                file=sys.stderr,
            )
        if (
            len(history) > WINDOW
            and history[-1 - WINDOW] - cost < REL_EPS * cost
        ):
            break

    # ship the best topology seen — never worse than the input tree
    left, right, root = best_snap

    # --- rebuild boxes bottom-up over the snapshot topology, then the
    # node list (negative child = smaller center on the widest-
    # separation axis, matching flatten/create_hitmiss) ---
    new_nodes: list[BVHNode | None] = [None] * N
    post: list[int] = []
    stack = [root]
    while stack:
        i = stack.pop()
        post.append(i)
        if left[i] >= 0:
            stack.append(left[i])
            stack.append(right[i])
    bmin = np.empty((N, 3), np.float64)
    bmax = np.empty((N, 3), np.float64)
    for i in reversed(post):
        if left[i] < 0:
            nd = nodes[i]
            bmin[i] = (x0[i], y0[i], z0[i])
            bmax[i] = (x1[i], y1[i], z1[i])
            new_nodes[i] = BVHNode(
                boxmin=bmin[i].astype(np.float32),
                boxmax=bmax[i].astype(np.float32),
                start=start[i],
                count=count[i],
            )
        else:
            l, r = left[i], right[i]
            bmin[i] = np.minimum(bmin[l], bmin[r])
            bmax[i] = np.maximum(bmax[l], bmax[r])
            cl = 0.5 * (bmin[l] + bmax[l])
            cr = 0.5 * (bmin[r] + bmax[r])
            axis = int(np.argmax(np.abs(cl - cr)))
            neg, pos = (l, r) if cl[axis] <= cr[axis] else (r, l)
            new_nodes[i] = BVHNode(
                boxmin=bmin[i].astype(np.float32),
                boxmax=bmax[i].astype(np.float32),
                axis=axis,
                negative=neg,
                positive=pos,
            )
    if verbose:
        print(
            f"bvh-opt: SAH {cost0:.5g} -> {best_cost_seen:.5g} "
            f"({best_cost_seen / cost0:.3f}x) in "
            f"{time.monotonic() - t0:.1f}s, {pass_i + 1} passes",
            file=sys.stderr,
        )
    return dataclasses.replace(bvh, nodes=new_nodes, root=root)
