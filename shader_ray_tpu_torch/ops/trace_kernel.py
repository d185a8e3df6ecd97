"""Trace-only kernels: object-space rays in, per ray the hit distance,
the triangle id, the interpolated normal and a bad flag out — over the
8-wide tree (``trace_wide``) or the binary tree (``trace_binary``), for
the closest hit or any hit.

``trace_wide`` replaces the TPU kernel ``wide_kernel``
(shader_ray_tpu/ops/pallas/kernel_wide.py, launched by
packet_wide.packet_trace_wide); ``trace_binary`` replaces
``packet_kernel`` (kernel_body.py, launched by packet.packet_trace).
Both keep the reference's ``PacketHit`` contract: an inactive ray
returns ``t = INFINITELY_FAR``, ``which = -1``; a ray that exceeds the
stack or the step budget ``t = -1``, ``which = -1``, ``bad``; an any-hit
walk that finds a hit ``t = 0`` (and records no id or normal).

Each wrapper runs its plain PyTorch version (``walk_plain``,
``walk_binary_plain``) for CPU tensors and launches its hand-written
CUDA kernel (``csrc/trace_kernel.cu``, ``csrc/trace_binary_kernel.cu``,
built with nvcc at first use) for CUDA tensors, or raises.  The wide
walk is the one the fused frame kernel runs (``csrc/walk.cuh``), so the
fused and unfused paths accept the same hits; it tests leaves in the form
its tables were packed in (``PackedWide.isect``, ``Config.leaf_isect``):
Woop rows, or Moller-Trumbore on v0 and the two edges, one kernel
instantiation each, counted apart (``launch_name``).  Given an image's
``width``, the kernels walk its pixels' rays in 8x16 tiles; the results
do not depend on it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from shader_ray_tpu_torch.ops import _build
from shader_ray_tpu_torch.ops.pack import PackedBinary
from shader_ray_tpu_torch.ops.pack_wide import (
    COUNT_SHIFT,
    FIRST_MASK,
    ISECTS,
    LEAF_STRIDE,
    WIDE,
    PackedWide,
)

INFINITELY_FAR = 1.0e7   # fs:115
RANGE_T1 = 1.0e8         # fs:463,491
MAX_STACK = 128          # per-thread stack slots in the kernels


class PacketHit(NamedTuple):
    t: torch.Tensor        # (R,) f32; INFINITELY_FAR = miss, 0 = any-hit found, -1 = bad
    which: torch.Tensor    # (R,) i32 BVH-order triangle id, -1 = none
    normal: torch.Tensor   # (R, 3) f32 interpolated object-space normal
    bad: torch.Tensor      # (R,) bool
    stats: torch.Tensor | None  # (R, 3) i32 per ray: steps, leaf visits, triangle tests


class WalkResult(NamedTuple):
    t: torch.Tensor        # (R,) f32; INFINITELY_FAR = miss, 0 = any-hit found
    normal: torch.Tensor   # (R, 3) f32 interpolated object-space normal
    which: torch.Tensor    # (R,) i64 BVH-order triangle id, -1 = none
    bad: torch.Tensor      # (R,) bool: stack or step budget exceeded
    steps: torch.Tensor    # (R,) i64 node pops
    leafs: torch.Tensor    # (R,) i64 leaf visits
    tris: torch.Tensor     # (R,) i64 triangle tests
    # the work a sequential walk with early exits does on these rays
    # (what an operation bound charges):
    slabs: torch.Tensor    # (R,) i64 box slab tests (non-empty children only; binary: = steps)
    tris_u: torch.Tensor   # (R,) i64 triangle tests that passed the distance test
    tris_v: torch.Tensor   # (R,) i64 ... and then passed u >= 0


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """Finite 1/d for slab math: a zero component maps to 1/1e-30.  With
    IEEE inf the slab terms turn NaN and the walk dies after the root
    pop — which silently un-shadowed axis-aligned lights on the TPU
    (kernel_body.py:48-59)."""
    return 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-30), d)


def isect_code(where: str, isect: str) -> int:
    """The kernels' code of a leaf test form (``ISECTS``); raises on any
    other."""
    if isect not in ISECTS:
        raise ValueError(f"{where}: leaf test {isect!r}: use one of {ISECTS}")
    return ISECTS.index(isect)


def launch_name(name: str, isect: str) -> str:
    """The ``LAUNCHES`` key of wide-walk kernel ``name`` ("frame_kernel",
    "trace_wide") in leaf test form ``isect``: the name itself for Woop,
    ``name + "_mt"`` for Moller-Trumbore."""
    return name if isect == "woop" else f"{name}_{isect}"


def mt_terms(rec: torch.Tensor, P: torch.Tensor, D: torch.Tensor):
    """Moller-Trumbore on test rows (M, 12) = v0, e0 = v1 - v0, e1 = v0 - v2
    (each padded to four floats) against rays (M, 3): (det, d, u, v),
    in the kernels' order of operations (csrc/walk.cuh: mt_hit;
    kernel_body.slot_hit, "mt" branch); the caller applies the accept
    tests."""
    v0, e0, e1 = rec[:, 0:3], rec[:, 4:7], rec[:, 8:11]
    M = torch.stack([
        e1[:, 1] * D[:, 2] - e1[:, 2] * D[:, 1],
        e1[:, 2] * D[:, 0] - e1[:, 0] * D[:, 2],
        e1[:, 0] * D[:, 1] - e1[:, 1] * D[:, 0],
    ], dim=1)
    det = e0[:, 0] * M[:, 0] + e0[:, 1] * M[:, 1] + e0[:, 2] * M[:, 2]
    minv_det = -1.0 / det
    inv_det = -minv_det
    T = P - v0
    Q = torch.stack([
        T[:, 1] * e0[:, 2] - T[:, 2] * e0[:, 1],
        T[:, 2] * e0[:, 0] - T[:, 0] * e0[:, 2],
        T[:, 0] * e0[:, 1] - T[:, 1] * e0[:, 0],
    ], dim=1)
    d = (e1[:, 0] * Q[:, 0] + e1[:, 1] * Q[:, 1] + e1[:, 2] * Q[:, 2]) * minv_det
    u = (T[:, 0] * M[:, 0] + T[:, 1] * M[:, 1] + T[:, 2] * M[:, 2]) * inv_det
    v = (D[:, 0] * Q[:, 0] + D[:, 1] * Q[:, 1] + D[:, 2] * Q[:, 2]) * inv_det
    return det, d, u, v


def walk_plain(
    packed: PackedWide,
    P: torch.Tensor,
    D: torch.Tensor,
    active: torch.Tensor,
    any_hit: bool,
    mt_eps: float = 1.0e-7,
    max_steps: int = 0,
) -> WalkResult:
    """Per-ray 8-wide short-stack walk, vectorized over rays: each step
    every open ray pops one node, slab-tests its 8 children in its
    octant's near-to-far order, tests the hit leaves' triangles
    near-to-far (Woop, or Moller-Trumbore: ``packed.isect``) and pushes
    the hit internal children far-to-near.  ``any_hit``
    stops a ray at its first accepted triangle.  A ray that overflows
    the stack or ``max_steps`` pops (0 = n_wide + 2) is bad.

    Hits accept at ``d <= t`` in visit order, so among equal distances
    the LAST tested triangle wins, exactly as the kernel's sequential
    loop and the reference leaf tests (kernel_body.py:78-102)."""
    mt = isect_code("walk_plain", packed.isect) == ISECTS.index("mt")
    R = P.shape[0]
    dev = P.device
    SD = packed.stack_depth
    max_steps = max_steps or packed.n_wide + 2
    MC = packed.max_count
    inv = safe_inv(D)
    octant = (D[:, 0] > 0).long() + 2 * (D[:, 1] > 0).long() + 4 * (D[:, 2] > 0).long()
    t = torch.full((R,), INFINITELY_FAR, dtype=torch.float32, device=dev)
    normal = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    which = torch.full((R,), -1, dtype=torch.long, device=dev)
    bad = torch.zeros(R, dtype=torch.bool, device=dev)
    steps = torch.zeros(R, dtype=torch.long, device=dev)
    leafs = torch.zeros(R, dtype=torch.long, device=dev)
    tris = torch.zeros(R, dtype=torch.long, device=dev)
    slabs = torch.zeros(R, dtype=torch.long, device=dev)
    tris_u = torch.zeros(R, dtype=torch.long, device=dev)
    tris_v = torch.zeros(R, dtype=torch.long, device=dev)
    stack = torch.zeros((R, SD), dtype=torch.long, device=dev)  # root = 0
    sp = active.long()
    shifts = 3 * torch.arange(WIDE, device=dev)
    slot_k = torch.arange(MC, device=dev)
    pos = torch.arange(WIDE, device=dev)
    node_bits = packed.nodes.view(torch.int32)
    big = WIDE * MC

    idx = torch.nonzero(sp > 0).squeeze(1)
    while idx.numel():
        spi = sp[idx] - 1
        node = stack[idx, spi]
        steps[idx] += 1
        Pi, Di, ti = P[idx], D[idx], t[idx]
        order = node_bits[node, octant[idx], 7].long()
        ck = (order[:, None] >> shifts) & 7                 # (M, 8) near first
        cm = node_bits[node[:, None], ck, 3].long()         # (M, 8)
        box = packed.nodes[node[:, None], ck]               # (M, 8, 8)
        ta = (box[..., 0:3] - Pi[:, None, :]) * inv[idx][:, None, :]
        tb = (box[..., 4:7] - Pi[:, None, :]) * inv[idx][:, None, :]
        lo = torch.minimum(ta, tb)
        hi = torch.maximum(ta, tb)
        t0 = torch.maximum(
            torch.maximum(lo[..., 0], lo[..., 1]), torch.clamp(lo[..., 2], min=0.0)
        )
        t1 = torch.minimum(
            torch.minimum(hi[..., 0], hi[..., 1]), torch.clamp(hi[..., 2], max=RANGE_T1)
        )
        slabs[idx] += (cm != -1).sum(1)
        hit = (cm != -1) & (t0 < t1) & (t0 < ti[:, None])
        leaf_hit = hit & (cm >= (1 << COUNT_SHIFT))
        push = hit & (cm >= 0) & (cm < (1 << COUNT_SHIFT))

        # leaf triangles near-to-far, flattened as key = p * MC + k
        cnt = torch.where(leaf_hit, cm >> COUNT_SHIFT, 0)
        slot_ok = slot_k < cnt[:, :, None]                  # (M, 8, MC)
        mi, pi, ki = torch.nonzero(slot_ok, as_tuple=True)
        tri = (cm[mi, pi] & FIRST_MASK) + ki
        key = pi * MC + ki
        rec = packed.leaves[tri]
        Ps, Ds = Pi[mi], Di[mi]
        if mt:
            det, d, u, v = mt_terms(rec, Ps, Ds)
            ok = torch.abs(det) >= mt_eps
        else:
            dz = rec[:, 0] * Ds[:, 0] + rec[:, 1] * Ds[:, 1] + rec[:, 2] * Ds[:, 2]
            oz = rec[:, 0] * Ps[:, 0] + rec[:, 1] * Ps[:, 1] + rec[:, 2] * Ps[:, 2] + rec[:, 3]
            ok = torch.abs(dz) >= mt_eps
            d = oz * (-1.0 / dz)
            u = (rec[:, 4] * Ps[:, 0] + rec[:, 5] * Ps[:, 1] + rec[:, 6] * Ps[:, 2] + rec[:, 7]) + d * (
                rec[:, 4] * Ds[:, 0] + rec[:, 5] * Ds[:, 1] + rec[:, 6] * Ds[:, 2]
            )
            v = (rec[:, 8] * Ps[:, 0] + rec[:, 9] * Ps[:, 1] + rec[:, 10] * Ps[:, 2] + rec[:, 11]) + d * (
                rec[:, 8] * Ds[:, 0] + rec[:, 9] * Ds[:, 1] + rec[:, 10] * Ds[:, 2]
            )
        ok &= (d <= ti[mi]) & (d >= 0.0)
        got_u = ok.clone()
        ok &= u >= 0.0
        got_v = ok.clone()
        ok &= (v >= 0.0) & (u + v <= 1.0)

        M = idx.numel()

        def per_ray(mask):
            return torch.zeros(M, dtype=torch.long, device=dev).scatter_add(0, mi, mask.long())

        if any_hit:
            first = torch.full((M,), big, dtype=torch.long, device=dev).scatter_reduce(
                0, mi, torch.where(ok, key, big), "amin"
            )
            tested = key <= first[mi]
            done = first < big
            last_p = torch.where(done, first // MC, WIDE - 1)
            leafs[idx] += (leaf_hit & (pos <= last_p[:, None])).sum(1)
            tris[idx] += per_ray(tested)
            tris_u[idx] += per_ray(tested & got_u)
            tris_v[idx] += per_ray(tested & got_v)
            t[idx[done]] = 0.0
        else:
            done = torch.zeros(M, dtype=torch.bool, device=dev)
            leafs[idx] += leaf_hit.sum(1)
            tris[idx] += slot_ok.sum((1, 2))
            tris_u[idx] += per_ray(got_u)
            tris_v[idx] += per_ray(got_v)
            best = torch.full((M,), float("inf"), device=dev).scatter_reduce(
                0, mi, torch.where(ok, d, float("inf")), "amin"
            )
            win = ok & (d == best[mi])
            wkey = torch.full((M,), -1, dtype=torch.long, device=dev).scatter_reduce(
                0, mi, torch.where(win, key, -1), "amax"
            )
            sel = win & (key == wkey[mi])
            rows = idx[mi[sel]]
            t[rows] = d[sel]
            which[rows] = tri[sel]
            us, vs, ns = u[sel, None], v[sel, None], packed.normals[tri[sel]]
            normal[rows] = ns[:, 0:3] + us * ns[:, 3:6] + vs * ns[:, 6:9]

        # push hit internal children far-to-near (nearest on top)
        for p in range(WIDE - 1, -1, -1):
            want = push[:, p] & ~done
            fits = want & (spi < SD)
            bad[idx[want & ~fits]] = True
            stack[idx[fits], spi[fits]] = cm[fits, p]
            spi = spi + fits.long()
        spi = torch.where(done, 0, spi)
        overflow = (steps[idx] >= max_steps) & (spi > 0)
        bad[idx[overflow]] = True
        spi = torch.where(overflow, 0, spi)
        sp[idx] = spi
        idx = idx[spi > 0]
    return WalkResult(t, normal, which, bad, steps, leafs, tris, slabs, tris_u, tris_v)


def walk_binary_plain(
    packed: PackedBinary,
    P: torch.Tensor,
    D: torch.Tensor,
    active: torch.Tensor,
    any_hit: bool,
    mt_eps: float = 1.0e-7,
    max_steps: int = 0,
) -> WalkResult:
    """Per-ray stackless walk of the binary tree, vectorized over rays:
    each ray walks the node bank of its OWN direction octant from record
    0 (the root); each step it slab-tests its record ``g``; on a box hit
    of a leaf it Moller-Trumbore-tests the leaf's triangles in order,
    accepting ``d <= t`` with ``d`` inside the leaf's slab range
    ``[t0, t1]`` (kernel_body.slot_hit, "mt" branch); then it goes to
    ``g + 1`` after a box hit of an inner node (its hit link) and to the
    record's miss link otherwise (a leaf's two links are equal).
    ``any_hit`` stops a ray at its first accepted triangle.  The normal
    of the accepted hit is interpolated once, after the walk.  A ray
    still walking after ``max_steps`` steps (0 = 2 * N + 2,
    packet.py:141) is bad."""
    R = P.shape[0]
    dev = P.device
    max_steps = max_steps or 2 * packed.node_count + 2
    inv = safe_inv(D)
    octant = (D[:, 0] > 0).long() + 2 * (D[:, 1] > 0).long() + 4 * (D[:, 2] > 0).long()
    t = torch.full((R,), INFINITELY_FAR, dtype=torch.float32, device=dev)
    bu = torch.zeros(R, dtype=torch.float32, device=dev)
    bv = torch.zeros(R, dtype=torch.float32, device=dev)
    which = torch.full((R,), -1, dtype=torch.long, device=dev)
    bad = torch.zeros(R, dtype=torch.bool, device=dev)
    steps = torch.zeros(R, dtype=torch.long, device=dev)
    leafs = torch.zeros(R, dtype=torch.long, device=dev)
    tris = torch.zeros(R, dtype=torch.long, device=dev)
    tris_u = torch.zeros(R, dtype=torch.long, device=dev)
    tris_v = torch.zeros(R, dtype=torch.long, device=dev)
    g = torch.where(active, 0, -1).long()
    miss_links = packed.miss.long()
    leaf_words = packed.leaf.long()

    idx = torch.nonzero(g >= 0).squeeze(1)
    while idx.numel():
        gi, oi = g[idx], octant[idx]
        steps[idx] += 1
        Pi, Di = P[idx], D[idx]
        rec = packed.nodes[oi, gi]                          # (M, 8)
        ta = (rec[:, 0:3] - Pi) * inv[idx]
        tb = (rec[:, 4:7] - Pi) * inv[idx]
        lo = torch.minimum(ta, tb)
        hi = torch.maximum(ta, tb)
        t0 = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), torch.clamp(lo[:, 2], min=0.0))
        t1 = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), torch.clamp(hi[:, 2], max=RANGE_T1))
        boxhit = (t0 < t1) & (t0 < t[idx])
        leaf = leaf_words[oi, gi]                           # -1: inner node
        cnt = torch.where(boxhit & (leaf >= 0), leaf >> COUNT_SHIFT, 0)
        first = leaf & FIRST_MASK
        leafs[idx] += (cnt > 0).long()

        found = torch.zeros(idx.numel(), dtype=torch.bool, device=dev)
        for k in range(int(cnt.max()) if cnt.numel() else 0):
            sel = torch.nonzero((cnt > k) & ~found).squeeze(1)
            if not sel.numel():
                break
            rows = idx[sel]
            tris[rows] += 1
            tri = first[sel] + k
            det, d, u, v = mt_terms(packed.tris[tri], Pi[sel], Di[sel])
            ok = torch.abs(det) >= mt_eps
            ok &= (d <= t[rows]) & (d >= t0[sel]) & (d <= t1[sel])
            tris_u[rows] += ok.long()
            ok &= u >= 0.0
            tris_v[rows] += ok.long()
            ok &= (v >= 0.0) & (u + v <= 1.0)
            hit_rows = rows[ok]
            if any_hit:
                t[hit_rows] = 0.0
                found[sel[ok]] = True
            else:
                t[hit_rows] = d[ok]
                which[hit_rows] = tri[ok]
                bu[hit_rows] = u[ok]
                bv[hit_rows] = v[ok]

        nxt = torch.where(boxhit & (leaf < 0), gi + 1, miss_links[oi, gi])
        nxt = torch.where(found, -1, nxt)
        overflow = (steps[idx] >= max_steps) & (nxt >= 0)
        bad[idx[overflow]] = True
        nxt = torch.where(overflow, -1, nxt)
        g[idx] = nxt
        idx = idx[nxt >= 0]
    normal = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    got = torch.nonzero(which >= 0).squeeze(1)
    if got.numel():
        nr = packed.normals[which[got]]
        normal[got] = (nr[:, 0:3] + bu[got, None] * nr[:, 4:7]) + bv[got, None] * nr[:, 8:11]
    return WalkResult(t, normal, which, bad, steps, leafs, tris, steps, tris_u, tris_v)


def packet_hit(w: WalkResult, with_stats: bool) -> PacketHit:
    """A plain walk's result under the PacketHit contract."""
    return PacketHit(
        t=torch.where(w.bad, -1.0, w.t),
        which=torch.where(w.bad, -1, w.which).int(),
        normal=w.normal,
        bad=w.bad,
        stats=torch.stack([w.steps, w.leafs, w.tris], dim=1).int() if with_stats else None,
    )


def _ray_args(where: str, tables: dict, P, D, active, width: int = 0):
    """Check the ray tensors against the tables' device and the image
    width (0, or one that divides the ray count); returns (device,
    active as a bool tensor)."""
    if active is None:
        active = torch.ones(P.shape[0], dtype=torch.bool, device=P.device)
    device = _build.one_device(where, dict(tables, P=P, D=D, active=active))
    R = P.shape[0]
    _build.check(where, "P", P, torch.float32, (R, 3))
    _build.check(where, "D", D, torch.float32, (R, 3))
    _build.check(where, "active", active, torch.bool, (R,))
    if width < 0 or (width and R % width):
        raise ValueError(f"{where}: width {width} does not divide {R} rays")
    return device, active


def _outputs(R: int, device, with_stats: bool):
    t = torch.empty(R, dtype=torch.float32, device=device)
    which = torch.empty(R, dtype=torch.int32, device=device)
    normal = torch.empty((R, 3), dtype=torch.float32, device=device)
    bad = torch.empty(R, dtype=torch.bool, device=device)
    stats = torch.empty((R, 3), dtype=torch.int32, device=device) if with_stats else None
    return t, which, normal, bad, stats


def launch_info(name: str, stack_depth: int, isect: str = "woop") -> dict[str, int]:
    """The launch of trace kernel ``name`` ("trace_wide", in leaf test
    form ``isect``, or "trace_binary") on the current card for a scene's
    stack bound: registers a thread, static and dynamic (stack) shared
    bytes a block, local bytes a thread, resident blocks an SM, threads a
    block."""
    if name == "trace_binary":
        return _build.launch_info("trace_binary_kernel", "srt_trace_binary_info", stack_depth)
    return _build.launch_info("trace_kernel", "srt_trace_wide_info", stack_depth,
                              isect_code("launch_info", isect))


@functools.cache
def _wide_entry():
    fn = _build.library("trace_kernel")[0].srt_trace_wide
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn.argtypes = [
        P, P, P, I,                # nodes, leaves, normals, leaf test form
        P, P, P, L, I,             # P, D, active, R, width
        I, F, I, I,                # any_hit, eps, max_steps, stack
        P, P, P, P, P, P,          # t, which, normal, bad, stats, stream
    ]
    fn.restype = I
    return fn


@functools.cache
def _binary_entry():
    fn = _build.library("trace_binary_kernel")[0].srt_trace_binary
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn.argtypes = [
        P, P, P,                   # nodes, tris, normals
        I, I, F,                   # node count, max_steps, eps
        P, P, P, L, I, I,          # P, D, active, R, width, any_hit
        P, P, P, P, P, P,          # t, which, normal, bad, stats, stream
    ]
    fn.restype = I
    return fn


def trace_wide(
    packed: PackedWide,
    P: torch.Tensor,
    D: torch.Tensor,
    active: torch.Tensor | None = None,
    any_hit: bool = False,
    mt_eps: float = 1.0e-7,
    max_steps: int = 0,
    with_stats: bool = False,
    width: int = 0,
) -> PacketHit:
    """Trace (R, 3) f32 object-space rays through the 8-wide tree, with
    the leaf test of ``packed.isect``.
    ``max_steps`` is the budget in node pops (0 = n_wide + 2).  A
    ``width`` > 0 says the rays are the pixels of a width-wide image,
    row-major: the kernel then walks them in 2D tiles (the results do not
    change).  CPU tensors run ``walk_plain``; CUDA tensors launch the
    CUDA kernel."""
    tables = dict(nodes=packed.nodes, leaves=packed.leaves, normals=packed.normals)
    device, active = _ray_args("trace_wide", tables, P, D, active, width)
    isect = isect_code("trace_wide", packed.isect)
    if device.type == "cpu":
        return packet_hit(walk_plain(packed, P, D, active, any_hit, mt_eps, max_steps),
                           with_stats)
    Nw = packed.n_wide
    _build.check("trace_wide", "nodes", packed.nodes, torch.float32, (Nw, WIDE, 8))
    _build.check("trace_wide", "leaves", packed.leaves, torch.float32, (None, LEAF_STRIDE))
    _build.check("trace_wide", "normals", packed.normals, torch.float32,
                 (packed.leaves.shape[0], LEAF_STRIDE))
    if not 1 <= packed.stack_depth <= MAX_STACK:
        raise ValueError(f"trace_wide: stack depth {packed.stack_depth} > {MAX_STACK}")
    fn = _wide_entry()
    R = P.shape[0]
    t, which, normal, bad, stats = _outputs(R, device, with_stats)
    if R == 0:
        return PacketHit(t, which, normal, bad, stats)
    name = launch_name("trace_wide", packed.isect)
    with torch.cuda.device(device), _build.traced(name):
        err = fn(
            packed.nodes.data_ptr(), packed.leaves.data_ptr(), packed.normals.data_ptr(), isect,
            P.data_ptr(), D.data_ptr(), active.data_ptr(), R, width,
            int(any_hit), mt_eps, max_steps or Nw + 2, packed.stack_depth,
            t.data_ptr(), which.data_ptr(), normal.data_ptr(), bad.data_ptr(),
            stats.data_ptr() if with_stats else None,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.launched(name, err)
    return PacketHit(t, which, normal, bad, stats)


def trace_binary(
    packed: PackedBinary,
    P: torch.Tensor,
    D: torch.Tensor,
    active: torch.Tensor | None = None,
    any_hit: bool = False,
    mt_eps: float = 1.0e-7,
    max_steps: int = 0,
    with_stats: bool = False,
    width: int = 0,
) -> PacketHit:
    """Trace (R, 3) f32 object-space rays through the binary tree.
    ``max_steps`` is the budget in node steps (0 = 2 * N + 2); ``width``
    as for ``trace_wide``.  CPU tensors run ``walk_binary_plain``; CUDA
    tensors launch the CUDA kernel."""
    tables = dict(nodes=packed.nodes, tris=packed.tris, normals=packed.normals)
    device, active = _ray_args("trace_binary", tables, P, D, active, width)
    if device.type == "cpu":
        return packet_hit(
            walk_binary_plain(packed, P, D, active, any_hit, mt_eps, max_steps), with_stats)
    N = packed.node_count
    _build.check("trace_binary", "nodes", packed.nodes, torch.float32, (8, N, 8))
    _build.check("trace_binary", "tris", packed.tris, torch.float32, (None, 12))
    _build.check("trace_binary", "normals", packed.normals, torch.float32, (packed.tris.shape[0], 12))
    fn = _binary_entry()
    R = P.shape[0]
    t, which, normal, bad, stats = _outputs(R, device, with_stats)
    if R == 0:
        return PacketHit(t, which, normal, bad, stats)
    with torch.cuda.device(device), _build.traced("trace_binary"):
        err = fn(
            packed.nodes.data_ptr(), packed.tris.data_ptr(), packed.normals.data_ptr(),
            N, max_steps or 2 * N + 2, mt_eps,
            P.data_ptr(), D.data_ptr(), active.data_ptr(), R, width, int(any_hit),
            t.data_ptr(), which.data_ptr(), normal.data_ptr(), bad.data_ptr(),
            stats.data_ptr() if with_stats else None,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.launched("trace_binary", err)
    return PacketHit(t, which, normal, bad, stats)


def trace(packed: PackedWide | PackedBinary, *args, **kwargs) -> PacketHit:
    """``trace_wide`` or ``trace_binary``: the table type picks
    (engine_pallas.py:253-256)."""
    if isinstance(packed, PackedWide):
        return trace_wide(packed, *args, **kwargs)
    return trace_binary(packed, *args, **kwargs)
