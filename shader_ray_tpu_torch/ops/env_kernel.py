"""The standalone environment sampler: final ray directions (and, in
grad mode, their image-plane differentials) in, radiance out.

``env_sample`` replaces the TPU kernels ``env_window_kernel`` /
``env_window_grad_kernel`` (shader_ray_tpu/ops/pallas/envwin.py,
launched by ``_run_window_kernel`` through ``sample_env_window`` and
``sample_env_window_grad``).  Mode 0 is the level-0 bilinear REPEAT
fetch (fs:153); grad mode is textureGrad (fs:146): a per-ray lod from
the analytic derivatives, trilinear between two pyramid levels, and
with ``aniso > 1`` ``ANISO_PROBES`` taps along the major footprint axis,
averaged.  Every ray reads exactly its own texels — the function the
TPU's per-tile windows approximate (ops/envmap.sample_environment of the
reference is the same per-ray function over a deeper mip chain).

A grad-mode ray whose derivatives are not finite (one along the +-y
axis: x = z = 0) gives NaN radiance, as in the reference, on every path:
NaN passes through the max, min and clamps, and the texel and level
indices it would make are clamped into range.

CPU tensors run ``env_sample_plain``; CUDA tensors launch the
hand-written kernel in ``csrc/env_kernel.cu`` (built with nvcc at first
use; one kernel a mode) or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from shader_ray_tpu_torch.ops import _build
from shader_ray_tpu_torch.ops.envmap import (
    TEXEL,
    EnvPyramid,
    aniso_lod_and_probes,
    bilinear_level,
    env_coords,
    env_derivatives,
)


def env_sample_plain(
    env: EnvPyramid,
    D: torch.Tensor,
    dDdx: torch.Tensor | None = None,
    dDdy: torch.Tensor | None = None,
    grad: bool = False,
    aniso: int = 1,
    touched: torch.Tensor | None = None,
    fetches: torch.Tensor | None = None,
) -> torch.Tensor:
    """``env_sample`` in plain PyTorch (envwin.py:664-701 for the lod,
    envmap.py:145-176 of the reference for the per-ray trilinear).
    What the function needs of the pyramid, for a bound: ``fetches``, an
    int64 scalar tensor, gets the number of bilinear fetches made at a
    non-zero weight added, and ``touched``, a bool tensor over
    ``env.texels``' rows, gets True at the four texels of each.  The
    upper level of a trilinear fetch whose lod lies exactly on a level
    has weight 0 and is not needed (the kernel skips it)."""
    u, v = env_coords(D)
    table = env.table
    if not grad:
        if fetches is not None:
            fetches.add_(u.numel())
        return bilinear_level(env.texels, table, torch.zeros_like(u, dtype=torch.long), u, v,
                              touched)
    dudx, dvdx, dudy, dvdy = env_derivatives(D, dDdx, dDdy)
    h0, w0 = (float(x) for x in env.base)
    rho_x = torch.sqrt((dudx * w0) ** 2 + (dvdx * h0) ** 2)
    rho_y = torch.sqrt((dudy * w0) ** 2 + (dvdy * h0) ** 2)
    top = env.n_levels - 1

    def trilinear(ui, vi, rho):
        lod = torch.clamp(torch.log2(torch.clamp(rho, min=1e-12)), 0.0, float(top))
        lf = torch.floor(lod)
        frac = (lod - lf)[..., None]
        l0 = torch.nan_to_num(lf, nan=0.0).long()  # a NaN lod reads level 0 at weight NaN
        upper = frac[..., 0] > 0.0
        if fetches is not None:
            fetches.add_(ui.numel() + upper.sum())
        c0 = bilinear_level(env.texels, table, l0, ui, vi, touched)
        c1 = bilinear_level(env.texels, table, torch.clamp(l0 + 1, max=top), ui, vi, touched,
                            upper)
        return c0 * (1 - frac) + c1 * frac

    if aniso <= 1:
        return trilinear(u, v, torch.maximum(rho_x, rho_y))
    rho_eff, offs = aniso_lod_and_probes(rho_x, rho_y, dudx, dvdx, dudy, dvdy, aniso)
    acc = None
    for tu, tv in offs:
        c = trilinear(u + tu, v + tv, rho_eff)
        acc = c if acc is None else acc + c
    return acc / float(len(offs))


MAX_LEVELS = 12  # levels the kernel takes (csrc/env_kernel.cu)
MODES = ("bilinear", "grad", "probes")  # the kernel's modes: mode 0, grad, grad with aniso > 1


@functools.cache
def _entry():
    fn = _build.library("env_kernel")[0].srt_env_sample
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, I, P, P, P, L, I, I, P, P]
    fn.restype = I
    return fn


def launch_info(mode: str) -> dict[str, int]:
    """The launch of the env kernel of ``mode`` (one of ``MODES``) on the
    current card: registers a thread, static and dynamic shared bytes a
    block, local bytes a thread, resident blocks an SM, threads a
    block."""
    return _build.launch_info("env_kernel", "srt_env_sample_info", MODES.index(mode))


def env_sample(
    env: EnvPyramid,
    D: torch.Tensor,
    dDdx: torch.Tensor | None = None,
    dDdy: torch.Tensor | None = None,
    grad: bool = False,
    aniso: int = 1,
) -> torch.Tensor:
    """Environment radiance (R, 3) for directions D (R, 3) f32; ``grad``
    needs the differentials dDdx, dDdy (R, 3).  CPU tensors run
    ``env_sample_plain``; CUDA tensors launch the CUDA kernel."""
    tensors = dict(texels=env.texels, D=D)
    if grad:
        if dDdx is None or dDdy is None:
            raise ValueError("env_sample: grad mode needs dDdx and dDdy")
        tensors.update(dDdx=dDdx, dDdy=dDdy)
    if aniso < 1:
        raise ValueError(f"env_sample: aniso={aniso}: need >= 1")
    device = _build.one_device("env_sample", tensors)
    if device.type == "cpu":
        return env_sample_plain(env, D, dDdx, dDdy, grad, aniso)
    R = D.shape[0]
    check = functools.partial(_build.check, "env_sample")
    check("texels", env.texels, torch.float32, (None, TEXEL))
    check("D", D, torch.float32, (R, 3))
    if grad:
        check("dDdx", dDdx, torch.float32, (R, 3))
        check("dDdy", dDdy, torch.float32, (R, 3))
    if not 1 <= env.n_levels <= MAX_LEVELS:
        raise ValueError(f"env_sample: {env.n_levels} levels, the kernel takes 1 to {MAX_LEVELS}")
    fn = _entry()
    out = torch.empty((R, 3), dtype=torch.float32, device=device)
    if R == 0:
        return out
    levels = (ctypes.c_int * (3 * env.n_levels))(*(x for row in env.levels for x in row))
    with torch.cuda.device(device), _build.traced("env_sample"):
        err = fn(
            env.texels.data_ptr(), levels, env.n_levels,
            D.data_ptr(), dDdx.data_ptr() if grad else None,
            dDdy.data_ptr() if grad else None, R, int(grad), aniso,
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _build.launched("env_sample", err)
    return out
