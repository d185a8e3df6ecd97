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

CPU tensors run ``env_sample_plain``; CUDA tensors launch the
hand-written kernel in ``csrc/env_kernel.cu`` (built with nvcc at first
use) or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from shader_ray_tpu_torch.ops import _build
from shader_ray_tpu_torch.ops.envmap import (
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
) -> torch.Tensor:
    """``env_sample`` in plain PyTorch (envwin.py:664-701 for the lod,
    envmap.py:145-176 of the reference for the per-ray trilinear).
    ``touched``, a bool tensor over ``env.texels``' rows, gets True at
    every texel these rays read (the bytes a bound charges)."""
    u, v = env_coords(D)
    if not grad:
        return bilinear_level(env.texels, env.table, torch.zeros_like(u, dtype=torch.long), u, v,
                              touched)
    dudx, dvdx, dudy, dvdy = env_derivatives(D, dDdx, dDdy)
    h0, w0 = (float(x) for x in env.base)
    rho_x = torch.sqrt((dudx * w0) ** 2 + (dvdx * h0) ** 2)
    rho_y = torch.sqrt((dudy * w0) ** 2 + (dvdy * h0) ** 2)
    top = env.n_levels - 1

    def trilinear(ui, vi, rho):
        lod = torch.clamp(torch.log2(torch.clamp(rho, min=1e-12)), 0.0, float(top))
        l0 = torch.floor(lod)
        frac = (lod - l0)[..., None]
        l0 = l0.long()
        c0 = bilinear_level(env.texels, env.table, l0, ui, vi, touched)
        c1 = bilinear_level(env.texels, env.table, torch.clamp(l0 + 1, max=top), ui, vi, touched)
        return c0 * (1 - frac) + c1 * frac

    if aniso <= 1:
        return trilinear(u, v, torch.maximum(rho_x, rho_y))
    rho_eff, offs = aniso_lod_and_probes(rho_x, rho_y, dudx, dvdx, dudy, dvdy, aniso)
    acc = None
    for tu, tv in offs:
        c = trilinear(u + tu, v + tv, rho_eff)
        acc = c if acc is None else acc + c
    return acc / float(len(offs))


@functools.cache
def _entry():
    fn = _build.library("env_kernel")[0].srt_env_sample
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, I, P, P, P, L, I, I, P, P]
    fn.restype = I
    return fn


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
    tensors = dict(texels=env.texels, table=env.table, D=D)
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
    check("texels", env.texels, torch.float32, (None, 3))
    check("table", env.table, torch.int32, (None, 3))
    check("D", D, torch.float32, (R, 3))
    if grad:
        check("dDdx", dDdx, torch.float32, (R, 3))
        check("dDdy", dDdy, torch.float32, (R, 3))
    fn = _entry()
    out = torch.empty((R, 3), dtype=torch.float32, device=device)
    if R == 0:
        return out
    with torch.cuda.device(device):
        err = fn(
            env.texels.data_ptr(), env.table.data_ptr(), env.n_levels,
            D.data_ptr(), dDdx.data_ptr() if grad else None,
            dDdy.data_ptr() if grad else None, R, int(grad), aniso,
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _build.launched("env_sample", err)
    return out
