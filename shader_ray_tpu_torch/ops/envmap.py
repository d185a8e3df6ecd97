"""Lat-long environment lookup for ``which = 0``: direction -> equirect
(u, v) (fs:121-125) and a level-0 bilinear REPEAT fetch (fs:153 samples
the native-resolution texture) — the counterpart of
shader_ray_tpu/ops/envmap.env_coords and ``_bilinear_level``.

The env is kept as ONE contiguous (H0, W0, 3) f32 tensor: at the bench
(1024 x 2048) that is 25 MB, resident in the H100's 50 MB L2.  Row 0 is
the top scanline and v = 1 maps to it (+y pole).
"""

from __future__ import annotations

import numpy as np
import torch

PI = 3.14159265259  # fs:116 (the reference's slightly-off pi, kept verbatim)
TAU = 2.0 * PI
MIN_H = 16          # smallest env level height the packer emits


def env_coords(D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u = 1 + atan2(-z, x)/tau in [0.5, 1.5] (REPEAT wraps it),
    v = 1 - acos(clamp(y))/pi.  D need not be unit in x/z."""
    u = 1.0 + torch.atan2(-D[..., 2], D[..., 0]) / TAU
    v = 1.0 - torch.acos(torch.clamp(D[..., 1], -1.0, 1.0)) / PI
    return u, v


def bilinear_level0(env: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear REPEAT-wrapped fetch from an (H0, W0, 3) env -> (..., 3)."""
    h, w = env.shape[0], env.shape[1]
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5  # v = 1 -> top row 0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = env.reshape(-1, 3)
    xi0 = torch.remainder(x0.long(), w)
    xi1 = torch.remainder(x0.long() + 1, w)
    yi0 = torch.remainder(y0.long(), h)
    yi1 = torch.remainder(y0.long() + 1, h)
    c00 = flat[yi0 * w + xi0]
    c10 = flat[yi0 * w + xi1]
    c01 = flat[yi1 * w + xi0]
    c11 = flat[yi1 * w + xi1]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_env(env: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``which = 0`` environment radiance for directions D (..., 3)."""
    u, v = env_coords(D)
    return bilinear_level0(env, u, v)


def _resize_env(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Integer-factor area average when possible, else index-sample
    (shader_ray_tpu/ops/pallas/pack._resize_env)."""
    h0, w0 = img.shape[:2]
    if h0 == H and w0 == W:
        return img
    if h0 % H == 0 and w0 % W == 0:
        fh, fw = h0 // H, w0 // W
        return img.reshape(H, fh, W, fw, 3).mean(axis=(1, 3)).astype(np.float32)
    yi = np.clip((np.arange(H) + 0.5) * h0 / H, 0, h0 - 1).astype(np.int64)
    xi = np.clip((np.arange(W) + 0.5) * w0 / W, 0, w0 - 1).astype(np.int64)
    return np.ascontiguousarray(img[yi][:, xi], dtype=np.float32)


def pack_env(env: np.ndarray, env_base: int = 1024) -> np.ndarray:
    """The env level 0 the frame samples: resampled to
    (H0, 2*H0) with H0 = min(env_base, pow2 >= source height), as the
    reference packer caps its plane pyramid (pack_wide.py:485-487)."""
    env = np.asarray(env, np.float32)
    src_h = max(int(env.shape[0]), MIN_H)
    h0 = min(env_base, 1 << (src_h - 1).bit_length())
    return np.ascontiguousarray(_resize_env(env, h0, 2 * h0), np.float32)
