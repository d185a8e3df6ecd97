"""Ray-differential transport and Schlick/filmic shading helpers
(reference raytracer.es.fs:58-106, 474-482, 524-548; counterpart of
shader_ray_tpu/ops/shading.py).  A batched ray is (P, D, dPdx, dDdx,
dPdy, dDdy), each (R, 3)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from shader_ray_tpu_torch.ops.vecmath import dot, reflect


class Rays(NamedTuple):
    """Batched ray with image-plane differentials (fs:58-63)."""

    P: torch.Tensor
    D: torch.Tensor
    dPdx: torch.Tensor
    dDdx: torch.Tensor
    dPdy: torch.Tensor
    dDdy: torch.Tensor


def ray_transfer(r: Rays, t: torch.Tensor, normal: torch.Tensor) -> Rays:
    """Propagate differentials across a surface transfer (fs:65-81)."""
    t1 = t[..., None]
    dn = dot(r.D, normal)[..., None]
    P = r.P + r.D * t1
    dtdx = -dot(r.dPdx + t1 * r.dDdx, normal)[..., None] / dn
    dPdx = r.dPdx + t1 * r.dDdx + dtdx * r.D
    dtdy = -dot(r.dPdy + t1 * r.dDdy, normal)[..., None] / dn
    dPdy = r.dPdy + t1 * r.dDdy + dtdy * r.D
    return Rays(P=P, D=r.D, dPdx=dPdx, dDdx=r.dDdx, dPdy=dPdy, dDdy=r.dDdy)


def ray_reflect(r: Rays, normal: torch.Tensor, surface_fudge: float = 1e-4) -> Rays:
    """Reflect with surface-fudge origin offset (fs:83-96).  The
    direction-differential update keeps the reference's quirk: it
    subtracts the SCALAR 2*dot(dDdx, n) from each component
    (fs:92-93)."""
    D = reflect(r.D, normal)
    P = r.P + normal * surface_fudge
    dDdx = r.dDdx - 2.0 * dot(r.dDdx, normal)[..., None]
    dDdy = r.dDdy - 2.0 * dot(r.dDdy, normal)[..., None]
    return Rays(P=P, D=D, dPdx=r.dPdx, dDdx=dDdx, dPdy=r.dPdy, dDdy=dDdy)


def f_schlick_vr(cspec: torch.Tensor, v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Schlick Fresnel in (view . reflected) half-angle form (fs:479-482):
    cspec + (1 - cspec) * (dot(v, r) * .5 + .5)^5."""
    f = (dot(v, r) * 0.5 + 0.5)[..., None] ** 5
    return cspec + (1.0 - cspec) * f


def filmic(c: torch.Tensor) -> torch.Tensor:
    """Filmic tonemap curve, per channel (fs:527-531)."""
    x = torch.clamp(c - 0.004, min=0.0)
    return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)


def tonemap_and_gamma(color: torch.Tensor, use_filmic: bool = True) -> torch.Tensor:
    """fs:533-548."""
    if use_filmic:
        return filmic(color)
    tone = color / (color + 1.0)
    return torch.pow(torch.clamp(tone, min=0.0), 1.0 / 2.63)
