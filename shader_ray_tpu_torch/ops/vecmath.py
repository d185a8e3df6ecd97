"""Small vector helpers over (..., 3) tensors (GLSL conventions).

Transforms are elementwise multiply-adds, never a matmul, so they stay
true f32 on every device and under any TF32 setting (a reduced-
precision camera transform warped every ray by ~0.66 px on the TPU,
shader_ray_tpu/ops/vecmath.py).
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) dot -> (...,)"""
    return (a * b).sum(dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = torch.sqrt((v * v).sum(dim=-1, keepdim=True))
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """GLSL reflect: d - 2*dot(d,n)*n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(4,4) matrix times (..., 3) points with w=1."""
    return (p[..., None, :] * m[:3, :3]).sum(dim=-1) + m[:3, 3]


def transform_dir(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(4,4) matrix times (..., 3) directions with w=0."""
    return (v[..., None, :] * m[:3, :3]).sum(dim=-1)
