"""Brute-force reference tracer on torch tensors (counterpart of
shader_ray_tpu/ops/reference.py, the test oracle).

An independent implementation of the render model: no BVH, every ray
tests every triangle with Moller-Trumbore, so it holds the walks (and
the kernels behind them) to an answer that shares none of their tables
or traversal.  It shares no code with ``ops.render`` or
``ops.trace_kernel`` beyond constants.  Tensors keep the dtype the caller
gives (f32 rays against f32 triangles compute in f32; ``render_reference``
builds its rays in f64, as the reference does) and lie on the ``device``
asked for.  ``intersect_brute`` walks the triangles in chunks, so a
69k-triangle scene against a few thousand rays fits a card's memory.
"""

from __future__ import annotations

import numpy as np
import torch

INFINITELY_FAR = 1.0e7
PI = 3.14159265259
TAU = 2.0 * PI
PAIRS = 1 << 22   # ray-triangle pairs a chunk of intersect_brute holds


def _tensor(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=device,
                           dtype=dtype)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def intersect_brute(tri_pos, P, D, eps: float = 1e-7, device=None):
    """All-pairs Moller-Trumbore: tri_pos (T, 3, 3), P and D (R, 3),
    numpy arrays or tensors, on ``device`` (default: P's, or the CPU).
    Returns (t, which, u, v) of the closest hit per ray: t =
    INFINITELY_FAR and which = -1 where none, the lowest triangle index
    among equal distances, and u, v of triangle 0 on a miss (the
    reference's argmin over all-miss rows)."""
    if device is None:
        device = P.device if torch.is_tensor(P) else "cpu"
    tri = _tensor(tri_pos, device)
    P, D = _tensor(P, device), _tensor(D, device)
    T, R = tri.shape[0], P.shape[0]
    dtype = torch.promote_types(tri.dtype, P.dtype)
    best_d = torch.full((R,), float("inf"), dtype=dtype, device=device)
    which = torch.zeros(R, dtype=torch.long, device=device)
    bu = torch.zeros(R, dtype=dtype, device=device)
    bv = torch.zeros(R, dtype=dtype, device=device)
    step = max(1, PAIRS // max(R, 1))
    Dx = D[:, None]                                   # (R, 1, 3)
    for c0 in range(0, T, step):
        v0, v1, v2 = (tri[c0:c0 + step, k][None] for k in range(3))   # (1, C, 3)
        e0 = v1 - v0
        e1 = v0 - v2
        M = _cross(e1, Dx)
        det = _dot(e0, M)                             # (R, C)
        ok = torch.abs(det) >= eps
        inv_det = torch.where(ok, 1.0 / torch.where(det == 0, torch.ones_like(det), det),
                              torch.zeros_like(det))
        Tv = P[:, None] - v0
        Q = _cross(Tv, e0.expand_as(Tv))
        d = -_dot(e1, Q) * inv_det
        ok &= (d >= 0.0) & (d <= 1e8)
        u = _dot(Tv, M) * inv_det
        ok &= (u >= 0.0) & (u <= 1.0)
        v = _dot(Dx, Q) * inv_det
        ok &= (v >= 0.0) & (u + v <= 1.0)
        d = torch.where(ok, d, torch.full_like(d, float("inf")))
        cd, ci = d.min(dim=1)                         # the first of equal minima
        if c0 == 0:
            bu, bv = u[:, 0], v[:, 0]
        closer = cd < best_d
        rows = torch.arange(R, device=device)
        best_d = torch.where(closer, cd, best_d)
        which = torch.where(closer, ci + c0, which)
        bu = torch.where(closer, u[rows, ci], bu)
        bv = torch.where(closer, v[rows, ci], bv)
    miss = ~torch.isfinite(best_d)
    t = torch.where(miss, torch.full_like(best_d, INFINITELY_FAR), best_d)
    return t, torch.where(miss, -1, which), bu, bv


def sample_env_bilinear(img, D, device=None) -> torch.Tensor:
    """Level-0 bilinear lat-long sample of the (h, w, 3) ``img`` along
    directions (R, 3), REPEAT wrap, row 0 = top."""
    if device is None:
        device = D.device if torch.is_tensor(D) else "cpu"
    img, D = _tensor(img, device), _tensor(D, device)
    h, w = img.shape[:2]
    u = 1.0 + torch.atan2(-D[:, 2], D[:, 0]) / TAU
    v = 1.0 - torch.arccos(torch.clamp(D[:, 1], -1, 1)) / PI
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def fetch(xi, yi):
        return img[torch.remainder(yi.long(), h), torch.remainder(xi.long(), w)]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def filmic(c: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(c - 0.004, min=0.0)
    return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)


def render_reference(
    tri_pos,
    tri_norm,
    env_img,
    width: int,
    height: int,
    fov: float = float(np.deg2rad(40.0)),
    camera_matrix=None,
    object_matrix=None,
    object_normal_matrix=None,
    object_normal_inverse=None,
    light_dir=(0.0, 0.0, 1.0),
    specular_color=(1.0, 0.71, 0.29),
    diffuse_color=(0.0, 0.0, 0.0),
    bounce_count: int = 3,
    cast_shadows: bool = True,
    tonemap: bool = True,
    surface_fudge: float = 1e-4,
    device="cpu",
) -> torch.Tensor:
    """The whole render model by brute force: one centred pinhole ray a
    pixel, ``bounce_count`` bounces of closest hit, Schlick and (where
    every diffuse component is positive) Lambert with shadow rays, the
    env term, the filmic tonemap -> (H, W, 3) f32 on ``device``.
    Matrices and rays in f64, triangles as given."""
    f64 = torch.float64
    eye = torch.eye(4, dtype=f64, device=device)

    def mat(m):
        return eye if m is None else _tensor(m, device, f64)

    cm, om, onm, oni = (mat(m) for m in (camera_matrix, object_matrix, object_normal_matrix,
                                         object_normal_inverse))
    light = _tensor(light_dir, device, f64)
    spec_c = _tensor(specular_color, device, f64)
    diff_c = _tensor(diffuse_color, device, f64)
    tri = _tensor(tri_pos, device)
    tn = _tensor(tri_norm, device, f64)
    env = _tensor(env_img, device)

    ipw = 2.0 * np.tan(fov / 2.0)
    aspect = height / width
    jj, ii = torch.meshgrid(torch.arange(height, dtype=f64, device=device),
                            torch.arange(width, dtype=f64, device=device), indexing="ij")
    u = (ii + 0.5) / width
    v = 1.0 - (jj + 0.5) / height
    d = torch.stack([ipw * (u - 0.5), ipw * (v - 0.5) * aspect, -torch.ones_like(u)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    D = d.reshape(-1, 3) @ cm[:3, :3].T
    D = D / torch.linalg.norm(D, dim=-1, keepdim=True)
    P = cm[:3, 3].expand_as(D).clone()
    R = D.shape[0]

    accumulated = torch.zeros((R, 3), dtype=f64, device=device)
    modulation = torch.ones((R, 3), dtype=f64, device=device)
    alive = torch.ones(R, dtype=torch.bool, device=device)
    for _ in range(bounce_count):
        objP = P @ om[:3, :3].T + om[:3, 3]
        objD = D @ onm[:3, :3].T
        t, which, uu, vv = intersect_brute(tri, objP, objD, device=device)
        hit_ok = alive & (t < INFINITELY_FAR)
        w = torch.clamp(which, min=0)
        n_obj = (tn[w, 0] * (1 - uu - vv)[:, None] + tn[w, 1] * uu[:, None]
                 + tn[w, 2] * vv[:, None])
        world_n = n_obj @ oni[:3, :3].T
        flip = (world_n * D).sum(-1) > 0
        world_n = torch.where(flip[:, None], -world_n, world_n)

        newP = P + D * t[:, None] + world_n * surface_fudge
        refl_D = D - 2 * (D * world_n).sum(-1)[:, None] * world_n
        spec = spec_c + (1 - spec_c) * (((D * refl_D).sum(-1) * 0.5 + 0.5)[:, None] ** 5)

        if bool((diff_c > 0).all()):
            lcos = torch.clamp((world_n * light).sum(-1), min=0.0)
            if cast_shadows:
                st, _, _, _ = intersect_brute(
                    tri, newP @ om[:3, :3].T + om[:3, 3],
                    light.expand(R, 3) @ onm[:3, :3].T, device=device)
                lit = st >= INFINITELY_FAR
            else:
                lit = torch.ones(R, dtype=torch.bool, device=device)
            add = modulation * diff_c * (lcos * lit)[:, None]
            accumulated = torch.where(hit_ok[:, None], accumulated + add, accumulated)

        modulation = torch.where(hit_ok[:, None], modulation * spec, modulation)
        P = torch.where(hit_ok[:, None], newP, P)
        D = torch.where(hit_ok[:, None], refl_D, D)
        alive = hit_ok

    color = accumulated + modulation * sample_env_bilinear(env, D, device)
    if tonemap:
        color = filmic(color)
    return color.reshape(height, width, 3).to(torch.float32)
