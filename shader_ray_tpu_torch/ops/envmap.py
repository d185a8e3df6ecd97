"""Lat-long environment lookup: direction -> equirect (u, v)
(fs:121-125), the analytic texture-coordinate derivatives (fs:135-142),
the anisotropic-sampler approximation, and bilinear REPEAT fetches from
the env pyramid — the counterpart of shader_ray_tpu/ops/envmap.py.

The pyramid (``pack_env_pyramid``) is ONE flat (texels, 4) f32 tensor,
a texel RGB and a zero pad (16 bytes: one 128-bit load on the card),
with a (texel offset, height, width) row per level: the pow2 base level,
then 2x2 box means until height 16, as the reference's plane pyramid
(ops/pallas/envwin.pack_env_planes) without its guard rows, seam phases
and lane padding.  Level 0 comes first, so the (H0, W0, 4) tensor the
frame kernel samples is a view of it: at the bench (1024 x 2048) 33.5 MB
of 44.7 MB; the texels a frame reads (0.63 MB at the bench primaries)
stay in the H100's 50 MB L2.  Row 0 is the top scanline and v = 1 maps
to it (+y pole).

Texel indices wrap exactly (``wrap``) for every finite coordinate; a
coordinate that is not finite (a grad-mode ray along the +-y axis
divides 0 by 0) reads texel 0 of its level with a NaN weight, so the
radiance is NaN as in the reference, whose gathers clamp their indices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

PI = 3.14159265259  # fs:116 (the reference's slightly-off pi, kept verbatim)
TAU = 2.0 * PI
MIN_H = 16          # smallest env level height the packer emits
TEXEL = 4           # floats a packed texel: RGB and a zero pad
ANISO_PROBES = 4    # probe taps of the aniso approximation (GL
                    # MAX_ANISOTROPY 4, ray.cpp:505-508)


@dataclass
class EnvPyramid:
    """The packed env pyramid (module docstring)."""

    texels: torch.Tensor                       # (texels, TEXEL) f32, level 0 first
    levels: tuple[tuple[int, int, int], ...]   # per level: texel offset, height, width
    table: torch.Tensor = field(init=False)    # (NL, 3) i32 of ``levels`` on the texels'
                                               # device, for the plain versions' gathers

    def __post_init__(self):
        self.table = torch.tensor(self.levels, dtype=torch.int32, device=self.texels.device)

    @property
    def base(self) -> tuple[int, int]:
        """(H0, W0)."""
        return self.levels[0][1], self.levels[0][2]

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def level0(self) -> torch.Tensor:
        """(H0, W0, TEXEL) view of level 0."""
        h, w = self.base
        return self.texels[: h * w].view(h, w, TEXEL)

    def to(self, device) -> "EnvPyramid":
        return EnvPyramid(self.texels.to(device), self.levels)

    @staticmethod
    def pack(env: np.ndarray, env_base: int = 1024) -> "EnvPyramid":
        texels, table = pack_env_pyramid(env, env_base)
        return EnvPyramid(torch.from_numpy(texels), tuple(tuple(int(x) for x in r) for r in table))


def env_coords(D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u = 1 + atan2(-z, x)/tau in [0.5, 1.5] (REPEAT wraps it),
    v = 1 - acos(clamp(y))/pi.  D need not be unit in x/z."""
    u = 1.0 + torch.atan2(-D[..., 2], D[..., 0]) / TAU
    v = 1.0 - torch.acos(torch.clamp(D[..., 1], -1.0, 1.0)) / PI
    return u, v


def env_derivatives(D: torch.Tensor, dDdx: torch.Tensor, dDdy: torch.Tensor):
    """Analytic du/dv derivatives w.r.t. the image plane (fs:135-142):
    (dudx, dvdx, dudy, dvdy).  Only ``denom_v`` is clamped, as in the
    reference: a ray straight along +-y divides by zero in ``dudx``."""
    x, y, z = D[..., 0], D[..., 1], D[..., 2]
    denom_u = TAU * (x * x + z * z)
    dudx = (x * dDdx[..., 2] - z * dDdx[..., 0]) / denom_u
    dudy = (x * dDdy[..., 2] - z * dDdy[..., 0]) / denom_u
    denom_v = PI * torch.sqrt(torch.clamp(1.0 - y * y, min=1e-12))
    dvdx = dDdx[..., 1] / denom_v
    dvdy = dDdy[..., 1] / denom_v
    return dudx, dvdx, dudy, dvdy


def dy_picture(D: torch.Tensor, dDdx: torch.Tensor, dDdy: torch.Tensor) -> torch.Tensor:
    """``which = 2``: the dY differential visualization (fs:147-149),
    (|du/dy| x 100, |dv/dy| x 100, 0) -> (..., 3).  NaN along +-y."""
    _, _, dudy, dvdy = env_derivatives(D, dDdx, dDdy)
    return torch.stack([torch.abs(dudy) * 100.0, torch.abs(dvdy) * 100.0, torch.zeros_like(dudy)],
                       dim=-1)


def aniso_lod_and_probes(rho_x, rho_y, dudx, dvdx, dudy, dvdy, aniso: int):
    """The anisotropic-sampler approximation (envmap.py:91-117 of the
    reference):

      N_eff = clip(rho_max / rho_min, 1, aniso)
      lod   = log2(max(rho_min, rho_max / aniso))
      probes: ANISO_PROBES taps at t_i = ((i+.5)/P - .5)*(1 - 1/N_eff)
              along the MAJOR gradient axis, equal weights

    Returns (rho_eff, [(tu_i, tv_i)] uv offsets)."""
    use_x = rho_x >= rho_y
    rho_max = torch.maximum(rho_x, rho_y)
    rho_min = torch.minimum(rho_x, rho_y)
    n_eff = torch.clamp(rho_max / torch.clamp(rho_min, min=1e-12), 1.0, float(aniso))
    rho_eff = torch.maximum(rho_min, rho_max / float(aniso))
    du_maj = torch.where(use_x, dudx, dudy)
    dv_maj = torch.where(use_x, dvdx, dvdy)
    spread = 1.0 - 1.0 / n_eff
    offs = []
    for i in range(ANISO_PROBES):
        t = ((i + 0.5) / ANISO_PROBES - 0.5) * spread
        offs.append((t * du_maj, t * dv_maj))
    return rho_eff, offs


def wrap(x: torch.Tensor, n) -> torch.Tensor:
    """floor(x) mod n as int64, for an integral f32 ``x`` and a power of
    two ``n``: exact for every finite x (each step is: a power-of-two
    scale, a floor, a difference that is an integer below n).  A
    non-finite x gives index 0 (its bilinear weight is NaN)."""
    r = x - torch.floor(x / n) * n
    return torch.nan_to_num(r, nan=0.0).long()


def bilinear_level(
    pyramid: torch.Tensor, table: torch.Tensor, level: torch.Tensor,
    u: torch.Tensor, v: torch.Tensor, touched: torch.Tensor | None = None,
    need: torch.Tensor | None = None,
) -> torch.Tensor:
    """Bilinear REPEAT-wrapped fetch at a per-ray pyramid level
    (``level`` int64, same shape as u) -> (..., 3); the +1 neighbour is
    wrapped from x0 + 1 in f32.  ``touched``, a bool tensor over the
    pyramid's texels, gets True at every texel read by the rays in
    ``need`` (a bool mask like u; all rays if None)."""
    tbl = table.long()[level]
    off, h, w = tbl[..., 0], tbl[..., 1], tbl[..., 2]
    hf, wf = h.float(), w.float()
    x = u * wf - 0.5
    y = (1.0 - v) * hf - 0.5  # v = 1 -> top row 0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0, xi1 = wrap(x0, wf), wrap(x0 + 1.0, wf)
    yi0, yi1 = wrap(y0, hf), wrap(y0 + 1.0, hf)
    taps = [off + yi0 * w + xi0, off + yi0 * w + xi1, off + yi1 * w + xi0, off + yi1 * w + xi1]
    if touched is not None:
        for i in taps:
            touched[i if need is None else i[need]] = True
    c00, c10, c01, c11 = (pyramid[i, :3] for i in taps)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def bilinear_level0(env: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear REPEAT-wrapped fetch from an (H0, W0, C) env (C = 3, or
    TEXEL for the pyramid's level 0; power-of-two H0, W0) -> (..., 3);
    the +1 neighbour is the next index after wrap(x0)."""
    h, w = env.shape[0], env.shape[1]
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5  # v = 1 -> top row 0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = env.reshape(-1, env.shape[-1])[:, :3]
    xi0, yi0 = wrap(x0, w), wrap(y0, h)
    xi1 = torch.where(xi0 + 1 == w, 0, xi0 + 1)
    yi1 = torch.where(yi0 + 1 == h, 0, yi0 + 1)
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


def pack_env_pyramid(env: np.ndarray, env_base: int = 1024) -> tuple[np.ndarray, np.ndarray]:
    """(pyramid (texels, TEXEL) f32, RGB and a zero pad; table (NL, 3)
    i32 of (texel offset, h, w)): ``pack_env``'s level 0, then 2x2 box
    means down to height ``MIN_H`` (the levels of
    envwin.pack_env_planes)."""
    cur = pack_env(env, env_base)
    levels, rows, off = [], [], 0
    while True:
        h, w = cur.shape[:2]
        levels.append(cur.reshape(-1, 3))
        rows.append((off, h, w))
        off += h * w
        if h <= MIN_H:
            break
        cur = cur.reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3)).astype(np.float32)
    rgb = np.concatenate(levels, axis=0)
    texels = np.zeros((rgb.shape[0], TEXEL), np.float32)
    texels[:, :3] = rgb
    return texels, np.asarray(rows, np.int32)


def pack_env(env: np.ndarray, env_base: int = 1024) -> np.ndarray:
    """The env level 0 the frame samples: resampled to
    (H0, 2*H0) with H0 = min(env_base, pow2 >= source height), as the
    reference packer caps its plane pyramid (pack_wide.py:485-487)."""
    env = np.asarray(env, np.float32)
    src_h = max(int(env.shape[0]), MIN_H)
    h0 = min(env_base, 1 << (src_h - 1).bit_length())
    return np.ascontiguousarray(_resize_env(env, h0, 2 * h0), np.float32)
