"""Host-side packet-traversal simulator, a tree-quality proxy (numpy copy
of shader_ray_tpu/models/quality.py; on the same SceneData its results
are the reference's, tests/test_torch_quality.py).

It mirrors the reference's packet walk over the 8-wide tree (its
kernel_wide.py over the pack_wide collapse: 4096-ray packets, one walk
union a packet, ``pops`` stack entries a step) in vectorized numpy, so
per-packet walk steps and leaf visits of a (scene build, camera) can be
estimated on a host.  Use it to compare build knobs (``splits`` object
or sbvh, ``bvh_leaf_max``, ``collapse`` sah or greedy):
``simulate_frame`` traces the six phases of the fused frame (3 specular
bounces, each followed by a hard-shadow any-hit pass, reference
raytracer.es.fs:552-582) and reports per-phase steps and leaf visits a
packet.  The port's kernels walk one ray a thread, so these per-packet
counts are not the port's per-ray node pops (``Renderer.make_stats_fn``);
they compare trees, not machines.

It is a RELATIVE proxy, not a timer: exact f32 boxes, children ordered
by mean-direction center projection instead of the per-octant orders,
and no jitter packing or min-contrib retirement.  Closest-hit RESULTS
(t, which, u, v) are exact: the Moller-Trumbore accept set is the
reference traversal's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.world import SceneData

BIG_T = np.float32(1e7)  # fs:115 initial hit distance
MT_EPS = 1e-7            # fs:312


@dataclass
class WideTreeHost:
    """Host view of the production wide tree: per wide node, the list
    of child BINARY node ids (leaves keep their (start, count) range;
    internal children map to another wide id via ``wid_of``)."""

    children: list[list[int]]
    wid_of: dict[int, int]
    is_leaf: np.ndarray          # (N,) bool over binary ids
    boxes: np.ndarray            # (N, 8) f32 binary node boxes
    objects: np.ndarray          # (N, 2) i32 (start, count)
    subtree_tris: np.ndarray | None = None  # (N,) i64 tris under node


def build_wide_tree(data: SceneData, config: Config | None = None) -> WideTreeHost:
    cfg = config or Config()
    from shader_ray_tpu_torch.ops.pack_wide import COLLAPSES

    wide_children, wid_of, _depth, is_leaf = COLLAPSES[cfg.collapse](data)
    objects = np.asarray(data.node_objects, np.int32)
    is_leaf = np.asarray(is_leaf, bool)
    subtree = None
    if data.node_children is not None:
        # flattening is DFS IN-order (flatten.generate_group_indices:
        # negative child < parent < positive child), so accumulate with
        # an explicit post-order pass instead of an index sweep
        ch = np.asarray(data.node_children, np.int64)
        subtree = np.where(is_leaf, objects[:, 1].astype(np.int64), -1)
        stack = [int(data.tree_root)]
        while stack:
            i = stack.pop()
            if subtree[i] >= 0:
                continue
            a, b = int(ch[i, 0]), int(ch[i, 1])
            if subtree[a] >= 0 and subtree[b] >= 0:
                subtree[i] = subtree[a] + subtree[b]
            else:
                stack.extend((i, a, b))
    return WideTreeHost(
        children=wide_children,
        wid_of=wid_of,
        is_leaf=is_leaf,
        boxes=np.asarray(data.node_boxes, np.float32),
        objects=objects,
        subtree_tris=subtree,
    )


@dataclass
class WalkStats:
    steps: int = 0
    leaf_visits: int = 0
    leaf_slot_tests: int = 0


@dataclass
class PhaseStats:
    """Per-phase aggregate, normalized per packet (matching the
    on-chip stats command's steps/pkt + leafs/pkt columns)."""

    name: str
    packets: int = 0
    steps: int = 0
    leafs: int = 0
    slot_tests: int = 0

    @property
    def steps_per_pkt(self) -> float:
        return self.steps / max(self.packets, 1)

    @property
    def leafs_per_pkt(self) -> float:
        return self.leafs / max(self.packets, 1)


def simulate_packet_walk(
    data: SceneData,
    wt: WideTreeHost,
    P: np.ndarray,
    D: np.ndarray,
    active: np.ndarray | None = None,
    any_hit: bool = False,
    pops: int = 4,
    max_leaf_tests: int | None = None,
    stats: WalkStats | None = None,
    leaf_order: str = "near",
    seed_leaf: tuple[int, int] | None = None,
    seed_out: dict | None = None,
):
    """Walk one packet (R rays) through the wide tree.

    Returns (t, which, u, v, hit_mask).  ``active`` masks lanes that
    participate (dead lanes neither prune nor expand the union —
    exactly the kernel's retired-lane behavior).  ``any_hit`` retires
    lanes on first accepted hit and stops when none remain (the
    occlusion walk, kernel_mega shadow phases).

    ``leaf_order`` is an EXPERIMENT knob for any-hit walks: "near"
    (production: near-to-far, same as closest-hit), "count" (descending
    slot count — visit the densest candidate first, maximizing the
    chance of early lane retirement).  Ignored for closest-hit walks,
    where near-to-far is required for t pruning.

    ``seed_leaf`` (EXPERIMENT, any-hit only) is a (start, count) leaf
    range tested BEFORE the walk — e.g. the previous packet's best
    occluder; lanes it retires shrink the walk union from step 0.
    When ``seed_out`` is a dict, the walk records the leaf that
    retired the most lanes under key "best" (None if no leaf retired
    anything) — feed it to the next packet's ``seed_leaf``.
    """
    R = P.shape[0]
    act = np.ones(R, bool) if active is None else active.copy()
    best_t = np.full(R, BIG_T, np.float32)
    which = np.full(R, -1, np.int32)
    u_out = np.zeros(R, np.float32)
    v_out = np.zeros(R, np.float32)
    hit = np.zeros(R, bool)
    st = stats if stats is not None else WalkStats()
    if not act.any():
        return best_t, which, u_out, v_out, hit

    tri = np.asarray(data.tri_positions, np.float32)
    # IEEE inf on zero components (fs:204-214); silence numpy's
    # divide-by-zero chatter — inf/nan lanes are masked downstream
    with np.errstate(divide="ignore", invalid="ignore"):
        invD = np.float32(1.0) / D
    mean_D = D[act].mean(axis=0)

    root_wid = 0
    stack: list[int] = [root_wid]
    try:
        err = np.errstate(divide="ignore", invalid="ignore", over="ignore")
        err.__enter__()
        return _walk_loop(
            data, wt, stack, act, P, D, invD, mean_D, tri, pops,
            max_leaf_tests, any_hit, st, best_t, which, u_out, v_out, hit,
            leaf_order, seed_leaf, seed_out,
        )
    finally:
        err.__exit__(None, None, None)


def _walk_loop(
    data, wt, stack, act, P, D, invD, mean_D, tri, pops,
    max_leaf_tests, any_hit, st, best_t, which, u_out, v_out, hit,
    leaf_order="near", seed_leaf=None, seed_out=None,
):
    lanes = np.arange(P.shape[0])
    best_seed = (None, 0)  # ((start, count), lanes retired)
    last_seed = None       # last leaf that retired any lane

    def test_leaf(start, count):
        """One leaf visit over all lanes; returns lanes newly retired
        (any-hit only).  Mutates the enclosing best/hit/act state."""
        nonlocal best_t, which, u_out, v_out, hit, act, best_seed
        if max_leaf_tests is not None:
            count = min(count, max_leaf_tests)
        if count <= 0:
            return 0
        st.leaf_visits += 1
        st.leaf_slot_tests += count
        # all slots at once, (S, R): min-d accept == the kernel's
        # in-order slot scan (d <= best_t accepts), up to exact-tie
        # which-index choice
        trows = tri[start : start + count]
        v0 = trows[:, None, 0:3]
        e0 = trows[:, None, 3:6] - v0
        e1 = v0 - trows[:, None, 6:9]
        M = np.cross(e1, D[None])
        det = (e0 * M).sum(-1)
        ok = np.abs(det) >= MT_EPS
        inv_det = np.float32(1.0) / np.where(ok, det, 1.0)
        T = P[None] - v0
        Q = np.cross(T, e0)
        d = -(e1 * Q).sum(-1) * inv_det
        ok &= (d <= best_t[None]) & (d >= 0.0) & act[None]
        uu = (T * M).sum(-1) * inv_det
        ok &= (uu >= 0.0) & (uu <= 1.0)
        vv = (D[None] * Q).sum(-1) * inv_det
        ok &= (vv >= 0.0) & (uu + vv <= 1.0)
        d_ok = np.where(ok, d, BIG_T * 2.0)
        s_best = d_ok.argmin(axis=0)
        lane_ok = ok[s_best, lanes]
        best_t = np.where(
            lane_ok, d[s_best, lanes].astype(np.float32), best_t
        )
        which = np.where(
            lane_ok, (start + s_best).astype(np.int32), which
        )
        u_out = np.where(
            lane_ok, uu[s_best, lanes].astype(np.float32), u_out
        )
        v_out = np.where(
            lane_ok, vv[s_best, lanes].astype(np.float32), v_out
        )
        hit |= lane_ok
        if any_hit:
            nonlocal last_seed
            retired = int((act & hit).sum())
            act &= ~hit
            if retired > best_seed[1]:
                best_seed = ((start, count), retired)
            if retired > 0:
                last_seed = (start, count)
            return retired
        return 0

    if any_hit and seed_leaf is not None and act.any():
        test_leaf(int(seed_leaf[0]), int(seed_leaf[1]))
        if seed_out is not None:
            seed_out["seed_retired"] = best_seed[1]

    while stack and act.any():
        group = [stack.pop() for _ in range(min(pops, len(stack)))]
        st.steps += 1
        kids: list[int] = []
        for wid in group:
            kids.extend(wt.children[wid])
        if not kids:
            continue
        b = np.asarray(kids, np.int32)
        bmin = wt.boxes[b, 0:3]  # (C, 3)
        bmax = wt.boxes[b, 3:6]
        # slab test, (C, R): division by zero D -> +-inf absorbed
        ta = (bmin[:, None, :] - P[None]) * invD[None]
        tb = (bmax[:, None, :] - P[None]) * invD[None]
        lo = np.minimum(ta, tb).max(axis=-1)
        hi = np.maximum(ta, tb).min(axis=-1)
        t0 = np.maximum(lo, 0.0)
        lane_hit = (t0 <= hi) & (t0 < best_t[None]) & act[None]
        child_hit = lane_hit.any(axis=1)

        order = np.argsort(
            (0.5 * (bmin + bmax) @ mean_D), kind="stable"
        )  # near -> far along the packet's mean direction
        leaves_near_to_far = [
            int(order[i]) for i in range(len(kids))
            if child_hit[order[i]] and wt.is_leaf[kids[order[i]]]
        ]
        if any_hit and leaf_order == "count":
            leaves_near_to_far.sort(
                key=lambda ci: -int(wt.objects[kids[ci]][1])
            )
        internal_far_to_near = [
            int(order[i]) for i in range(len(kids) - 1, -1, -1)
            if child_hit[order[i]] and not wt.is_leaf[kids[order[i]]]
        ]
        if any_hit and leaf_order == "count" and wt.subtree_tris is not None:
            # push sparsest first so the densest subtree pops next —
            # maximize early lane retirement for occlusion walks
            internal_far_to_near.sort(
                key=lambda ci: int(wt.subtree_tris[kids[ci]])
            )

        for ci in leaves_near_to_far:
            start, count = (int(x) for x in wt.objects[kids[ci]])
            test_leaf(start, count)
            if any_hit and not act.any():
                break
        if any_hit and not act.any():
            break
        for ci in internal_far_to_near:
            stack.append(wt.wid_of[kids[ci]])
    if seed_out is not None:
        seed_out["best"] = best_seed[0]
        seed_out["last"] = last_seed
    return best_t, which, u_out, v_out, hit


def _camera_rays(width, height, fov, cam_matrix):
    """Numpy mirror of ops/render.rays_for_pixels (pinhole, no jitter):
    row-major pixels, row 0 = top scanline."""
    ipw = 2.0 * np.tan(fov / 2.0)
    aspect = height / (1.0 * width)
    ii, jj = np.meshgrid(
        np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32)
    )
    un = (ii + 0.5) / width
    vn = 1.0 - (jj + 0.5) / height
    d = np.stack(
        [ipw * (un - 0.5), ipw * (vn - 0.5) * aspect, np.full_like(un, -1.0)],
        axis=-1,
    ).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    R = np.asarray(cam_matrix, np.float32)[:3, :3]
    P0 = np.asarray(cam_matrix, np.float32)[:3, 3]
    D = d @ R.T
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    P = np.broadcast_to(P0, D.shape).astype(np.float32)
    return P.copy(), D.astype(np.float32)


@dataclass
class FrameSimResult:
    phases: list[PhaseStats] = field(default_factory=list)

    @property
    def total_steps_per_pkt(self) -> float:
        return sum(p.steps_per_pkt for p in self.phases)

    @property
    def total_leafs_per_pkt(self) -> float:
        return sum(p.leafs_per_pkt for p in self.phases)

    def print(self, out=None) -> None:
        import sys

        out = out or sys.stderr
        for p in self.phases:
            print(
                f"  {p.name:9s} {p.steps_per_pkt:8.1f} steps/pkt"
                f" {p.leafs_per_pkt:8.1f} leafs/pkt"
                f" ({p.packets} packets)",
                file=out,
            )
        print(
            f"  {'TOTAL':9s} {self.total_steps_per_pkt:8.1f} steps/pkt"
            f" {self.total_leafs_per_pkt:8.1f} leafs/pkt",
            file=out,
        )


def simulate_frame(
    data: SceneData,
    width: int = 1024,
    height: int = 768,
    fov: float = np.deg2rad(40.0),
    cam_matrix: np.ndarray | None = None,
    light_dir: np.ndarray = np.array([0.0, 0.0, 1.0], np.float32),
    bounce_count: int = 3,
    cast_shadows: bool = True,
    tile: int = 4096,
    pops: int = 4,
    tile_stride: int = 1,
    config: Config | None = None,
    anyhit_leaf_order: str = "near",
    anyhit_seed: str = "",
) -> FrameSimResult:
    """Simulate the fused megakernel's six phases over the frame's
    packets and return per-phase walk statistics.

    ``tile_stride`` samples every k-th packet (the proxy's answer to
    divergent scenes whose full-frame walk would take minutes in
    numpy); stats stay per-packet so sampled and full runs compare.
    ``cam_matrix`` defaults to the bench framing: camera backed off so
    a scene of extent 2.6 fills a 40-degree fov (ray.cpp:1079).
    """
    cfg = config or Config()
    wt = build_wide_tree(data, cfg)
    normals = np.asarray(data.tri_normals, np.float32)
    if cam_matrix is None:
        from shader_ray_tpu_torch.utils import mat4

        zoom = 2.6 / 2.0 / np.sin(fov / 2.0)
        cam_matrix = mat4.make_translation(0.0, 0.0, zoom).astype(np.float32)
    P_all, D_all = _camera_rays(width, height, fov, cam_matrix)
    light = np.asarray(light_dir, np.float32)
    light = light / np.linalg.norm(light)

    n_rays = P_all.shape[0]
    n_tiles = (n_rays + tile - 1) // tile
    phases: list[PhaseStats] = []
    for b in range(bounce_count):
        phases.append(PhaseStats(f"bounce{b}"))
        if cast_shadows:
            phases.append(PhaseStats(f"shadow{b}"))
    # anyhit_seed EXPERIMENT: carry each shadow phase's best occluder
    # leaf to the next packet (the kernel analog is an SMEM scratch
    # scalar persisting across grid steps)
    prev_best: dict[int, tuple[int, int] | None] = {}

    for ti in range(0, n_tiles, tile_stride):
        sl = slice(ti * tile, min((ti + 1) * tile, n_rays))
        P = P_all[sl].copy()
        D = D_all[sl].copy()
        act = np.ones(P.shape[0], bool)
        pi = 0
        for b in range(bounce_count):
            ph = phases[pi]
            pi += 1
            st = WalkStats()
            t, which, uu, vv, hit = simulate_packet_walk(
                data, wt, P, D, active=act, any_hit=False, pops=pops,
                max_leaf_tests=cfg.max_leaf_tests, stats=st,
            )
            ph.packets += 1
            ph.steps += st.steps
            ph.leafs += st.leaf_visits
            ph.slot_tests += st.leaf_slot_tests

            w = np.maximum(which, 0)
            n = (
                (1.0 - uu - vv)[:, None] * normals[w, 0:3]
                + uu[:, None] * normals[w, 3:6]
                + vv[:, None] * normals[w, 6:9]
            )
            nrm = np.linalg.norm(n, axis=-1, keepdims=True)
            n = n / np.maximum(nrm, 1e-20)
            # flip backfacing (fs:507-512)
            dn = (D * n).sum(-1)
            n = np.where((dn > 0.0)[:, None], -n, n)
            dn = (D * n).sum(-1)
            hit_P = P + t[:, None] * D

            if cast_shadows:
                ph_s = phases[pi]
                pi += 1
                lcos = (n * light[None]).sum(-1)
                s_act = act & hit & (lcos > 0.0)
                st_s = WalkStats()
                sP = hit_P + n * 1e-4
                sD = np.broadcast_to(light, sP.shape).astype(np.float32).copy()
                seed_out: dict | None = {} if anyhit_seed else None
                simulate_packet_walk(
                    data, wt, sP, sD, active=s_act, any_hit=True, pops=pops,
                    max_leaf_tests=cfg.max_leaf_tests, stats=st_s,
                    leaf_order=anyhit_leaf_order,
                    seed_leaf=prev_best.get(b) if anyhit_seed else None,
                    seed_out=seed_out,
                )
                if anyhit_seed and seed_out.get(anyhit_seed) is not None:
                    # policy "best" = most-retiring leaf (kernel: one
                    # any-reduce per leaf visit); "last" = last leaf
                    # that retired anything (kernel: free pl.when store)
                    prev_best[b] = seed_out[anyhit_seed]
                ph_s.packets += 1
                ph_s.steps += st_s.steps
                ph_s.leafs += st_s.leaf_visits
                ph_s.slot_tests += st_s.leaf_slot_tests

            # reflect for the next bounce (fs:83-96)
            D = D - 2.0 * dn[:, None] * n
            P = hit_P + n * 1e-4
            act = act & hit
            if not act.any():
                break
    return FrameSimResult(phases=phases)
