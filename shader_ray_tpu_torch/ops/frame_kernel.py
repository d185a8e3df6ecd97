"""The fused frame kernel: raygen, 3 bounces of closest-hit walk +
Schlick/Lambert shading + any-hit shadow walk, the env term, bad-ray
paint and the jitter-sample mean, for a whole frame batch.

Replaces the TPU kernel ``mega_kernel``
(shader_ray_tpu/ops/pallas/kernel_mega.py, launched by
packet_mega.packet_shade) with its walker ``make_wide_walker``
(kernel_wide.py), the leaf math ``slot_hit``/``slot_normal``/
``safe_inv`` (kernel_body.py) and the fused env sampler
(envwin.env_window_body, trig.env_coords_kernel), for ``which = 0``.

``frame_kernel`` is the wrapper: CPU tensors run ``frame_plain``, the
same function in plain PyTorch; CUDA tensors launch the hand-written
kernel in ``csrc/frame_kernel.cu`` (built with nvcc at first use into
``shader_ray_tpu_torch/build/``) or raise.  Both return the linear
colour mean over the jitter samples and an int64 counter row:
``[0]`` rays cast (live bounce rays + lcos-gated shadow rays), then per
walk phase p (bounce walks and shadow walks interleaved, as the
reference stats row) ``[1+3p]`` node pops, ``[2+3p]`` leaf visits,
``[3+3p]`` triangle tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from shader_ray_tpu_torch.ops import _build
from shader_ray_tpu_torch.ops.envmap import TEXEL, sample_env
from shader_ray_tpu_torch.ops.pack_wide import LEAF_STRIDE, WIDE, PackedWide
from shader_ray_tpu_torch.ops.trace_kernel import INFINITELY_FAR, MAX_STACK, WalkResult, walk_plain

MAX_PHASES = 16          # walk phases the kernel's counter row holds

# uniform table layout (kernel_mega.py:43-54; ops/engine_frame.pack_uniforms)
UNI_OBJECT_MATRIX = 0    # [:3,:4] row-major, world->object points
UNI_NORMAL_MATRIX = 12   # [:3,:3] row-major, world->object directions
UNI_NORMAL_INVERSE = 21  # [:3,:3] row-major, object->world normals
UNI_LIGHT_DIR = 30       # (3,) world light direction
UNI_SPECULAR = 33        # (3,) specular color
UNI_DIFFUSE = 36         # (3,) diffuse color
UNI_CAM_ORIGIN = 39      # (3,) world camera position
UNI_CAM_NORMAL = 42      # [:3,:3] row-major camera normal matrix
UNI_IPW = 51             # () image plane width = 2*tan(fov/2)
UNI_SIZE = 52


class FrameSettings(NamedTuple):
    """The frame kernel's static arguments."""

    width: int
    height: int
    bounce_count: int = 3
    cast_shadows: bool = True
    enable_diffuse: bool = True
    surface_fudge: float = 1.0e-4
    mt_eps: float = 1.0e-7
    max_steps: int = 0          # node pops per walk; 0 = n_wide + 2

    def phases(self) -> int:
        shadows = self.cast_shadows and self.enable_diffuse
        return self.bounce_count * (2 if shadows else 1)


def frame_plain(
    packed: PackedWide,
    uni: torch.Tensor,
    jitters: torch.Tensor,
    fs: FrameSettings,
    probe: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The frame kernel's function in plain PyTorch, vectorized over all
    K * H * W sample rays (ray r = k * H * W + pixel): returns the
    (H, W, 3) linear colour mean over the K jitters and the counter
    row (module docstring).  Arithmetic follows the kernel op by op
    (kernel_mega.py:174-367 with which = 0).  A ``probe`` dict receives
    what an operation and byte count of the frame needs: ``"walks"``,
    each walk phase's ``WalkResult`` in order, and ``"env_D"``, the
    (K * H * W, 3) directions of the env lookup."""
    W, H = fs.width, fs.height
    K = jitters.shape[0]
    HW = W * H
    dev = uni.device
    u = [uni[i] for i in range(UNI_SIZE)]
    m = u[UNI_OBJECT_MATRIX : UNI_OBJECT_MATRIX + 12]
    nm = u[UNI_NORMAL_MATRIX : UNI_NORMAL_MATRIX + 9]
    ni = u[UNI_NORMAL_INVERSE : UNI_NORMAL_INVERSE + 9]
    Lx, Ly, Lz = u[UNI_LIGHT_DIR : UNI_LIGHT_DIR + 3]
    csp = u[UNI_SPECULAR : UNI_SPECULAR + 3]
    cdf = u[UNI_DIFFUSE : UNI_DIFFUSE + 3]
    cm = u[UNI_CAM_NORMAL : UNI_CAM_NORMAL + 9]
    ipw = u[UNI_IPW]
    counters = torch.zeros(1 + 3 * fs.phases(), dtype=torch.long, device=dev)

    # pinhole raygen (kernel_mega.py:203-220): two normalisations
    pix = torch.arange(HW, device=dev).repeat(K)
    iif = (pix % W).float()
    jf = (pix // W).float()
    jx = jitters[:, 0].repeat_interleave(HW)
    jy = jitters[:, 1].repeat_interleave(HW)
    inv_w, inv_h, aspect = _raygen_scalars(W, H)
    uu = (iif + 0.5 + jx) * inv_w
    vv = 1.0 - (jf + 0.5 + jy) * inv_h
    ex = ipw * (uu - 0.5)
    ey = (ipw * aspect) * (vv - 0.5)
    inv_e = 1.0 / torch.sqrt(ex * ex + ey * ey + 1.0)
    dex, dey, dez = ex * inv_e, ey * inv_e, -inv_e
    Dx = cm[0] * dex + cm[1] * dey + cm[2] * dez
    Dy = cm[3] * dex + cm[4] * dey + cm[5] * dez
    Dz = cm[6] * dex + cm[7] * dey + cm[8] * dez
    inv_d = 1.0 / torch.sqrt(Dx * Dx + Dy * Dy + Dz * Dz)
    Dx, Dy, Dz = Dx * inv_d, Dy * inv_d, Dz * inv_d
    R = K * HW
    Px, Py, Pz = (u[UNI_CAM_ORIGIN + i].expand(R) for i in range(3))

    oLx = nm[0] * Lx + nm[1] * Ly + nm[2] * Lz
    oLy = nm[3] * Lx + nm[4] * Ly + nm[5] * Lz
    oLz = nm[6] * Lx + nm[7] * Ly + nm[8] * Lz
    oL = torch.stack([oLx, oLy, oLz]).expand(R, 3)

    acc = [torch.zeros(R, device=dev) for _ in range(3)]
    mod = [torch.ones(R, device=dev) for _ in range(3)]
    act = torch.ones(R, dtype=torch.bool, device=dev)
    badv = torch.zeros(R, dtype=torch.bool, device=dev)
    shadows = fs.cast_shadows and fs.enable_diffuse
    phase = 0

    def record(w: WalkResult) -> None:
        nonlocal phase
        counters[1 + 3 * phase] += w.steps.sum()
        counters[2 + 3 * phase] += w.leafs.sum()
        counters[3 + 3 * phase] += w.tris.sum()
        phase += 1
        if probe is not None:
            probe.setdefault("walks", []).append(w)

    for _ in range(fs.bounce_count):
        counters[0] += act.sum()
        oP = torch.stack([
            m[0] * Px + m[1] * Py + m[2] * Pz + m[3],
            m[4] * Px + m[5] * Py + m[6] * Pz + m[7],
            m[8] * Px + m[9] * Py + m[10] * Pz + m[11],
        ], dim=1)
        oD = torch.stack([
            nm[0] * Dx + nm[1] * Dy + nm[2] * Dz,
            nm[3] * Dx + nm[4] * Dy + nm[5] * Dz,
            nm[6] * Dx + nm[7] * Dy + nm[8] * Dz,
        ], dim=1)
        w = walk_plain(packed, oP, oD, act, False, fs.mt_eps, fs.max_steps)
        record(w)
        t = w.t
        hit_ok = act & ~w.bad & (t < INFINITELY_FAR)
        badv |= act & w.bad

        # object -> world normal, flipped against the incoming ray
        nx, ny, nz = w.normal[:, 0], w.normal[:, 1], w.normal[:, 2]
        wnx = ni[0] * nx + ni[1] * ny + ni[2] * nz
        wny = ni[3] * nx + ni[4] * ny + ni[5] * nz
        wnz = ni[6] * nx + ni[7] * ny + ni[8] * nz
        flip = torch.where(wnx * Dx + wny * Dy + wnz * Dz > 0.0, -1.0, 1.0)
        wnx, wny, wnz = wnx * flip, wny * flip, wnz * flip

        # transfer + fudged reflect (fs:65-96)
        rPx = Px + t * Dx + wnx * fs.surface_fudge
        rPy = Py + t * Dy + wny * fs.surface_fudge
        rPz = Pz + t * Dz + wnz * fs.surface_fudge
        ddn = Dx * wnx + Dy * wny + Dz * wnz
        rDx = Dx - 2.0 * ddn * wnx
        rDy = Dy - 2.0 * ddn * wny
        rDz = Dz - 2.0 * ddn * wnz

        # Schlick in (view . reflected) half-angle form (fs:479-482)
        h = (Dx * rDx + Dy * rDy + Dz * rDz) * 0.5 + 0.5
        h2 = h * h
        fres = h2 * h2 * h
        spec = [c + (1.0 - c) * fres for c in csp]

        if fs.enable_diffuse:
            lcos = torch.clamp(wnx * Lx + wny * Ly + wnz * Lz, min=0.0)
            if fs.cast_shadows:
                # light-facing hits only (fs:454-464 cast unconditionally;
                # lcos == 0 adds no diffuse either way)
                sact = hit_ok & (lcos > 0.0)
                counters[0] += sact.sum()
                sP = torch.stack([
                    m[0] * rPx + m[1] * rPy + m[2] * rPz + m[3],
                    m[4] * rPx + m[5] * rPy + m[6] * rPz + m[7],
                    m[8] * rPx + m[9] * rPy + m[10] * rPz + m[11],
                ], dim=1)
                sw = walk_plain(packed, sP, oL, sact, True, fs.mt_eps, fs.max_steps)
                record(sw)
                badv |= sact & sw.bad
                irr = lcos * (sw.t >= INFINITELY_FAR).float()
            else:
                irr = lcos
            acc = [torch.where(hit_ok, a + mo * c * irr, a) for a, mo, c in zip(acc, mod, cdf)]

        mod = [torch.where(hit_ok, mo * s, mo) for mo, s in zip(mod, spec)]
        Px = torch.where(hit_ok, rPx, Px)
        Py = torch.where(hit_ok, rPy, Py)
        Pz = torch.where(hit_ok, rPz, Pz)
        Dx = torch.where(hit_ok, rDx, Dx)
        Dy = torch.where(hit_ok, rDy, Dy)
        Dz = torch.where(hit_ok, rDz, Dz)
        act = hit_ok

    env_D = torch.stack([Dx, Dy, Dz], dim=1)
    if probe is not None:
        probe["env_D"] = env_D
    env = sample_env(packed.env, env_D)
    col = torch.stack([a + mo * env[:, c] for c, (a, mo) in enumerate(zip(acc, mod))], dim=1)
    red = torch.tensor([1.0, 0.0, 0.0], device=dev)
    col = torch.where(badv[:, None], red, col).reshape(K, HW, 3)
    total = col[0]
    for k in range(1, K):
        total = total + col[k]
    return (total / K).reshape(H, W, 3), counters


def _raygen_scalars(W: int, H: int) -> tuple[float, float, float]:
    """1/W, 1/H and H/W rounded to f32 once, shared by both versions."""
    return (float(np.float32(1.0 / W)), float(np.float32(1.0 / H)),
            float(np.float32(H / W)))


@functools.cache
def _entry():
    """The library's entry point with its C signature set."""
    fn = _build.library("frame_kernel")[0].srt_frame_kernel
    P = ctypes.c_void_p
    I = ctypes.c_int
    F = ctypes.c_float
    fn.argtypes = [
        P, P, P, P, I, I,          # nodes, leaves, normals, env, env_h, env_w
        P, P, I, I, I,             # uni, jitters, K, W, H
        F, F, F,                   # 1/W, 1/H, H/W
        I, I, I, F, F, I, I,       # bounces, shadows, diffuse, fudge, eps, max_steps, stack
        P, P, P,                   # out, counters, stream
    ]
    fn.restype = I
    return fn


def launch_info(stack_depth: int) -> dict[str, int]:
    """The frame kernel's launch on the current card for a scene's stack
    bound: registers a thread, static and dynamic (stack) shared bytes a
    block, local bytes a thread, resident blocks an SM, threads a block
    and the tile."""
    return _build.launch_info("frame_kernel", "srt_frame_kernel_info", stack_depth,
                              (*_build.INFO_KEYS, "tile_w", "tile_h"))


def frame_kernel(
    packed: PackedWide,
    uni: torch.Tensor,
    jitters: torch.Tensor,
    fs: FrameSettings,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render K jittered samples of a W x H frame: (H, W, 3) f32 linear
    colour mean and the int64 counter row.  CPU tensors run
    ``frame_plain``; CUDA tensors launch the CUDA kernel."""
    tensors = dict(
        nodes=packed.nodes, leaves=packed.leaves, normals=packed.normals, env=packed.env,
        uni=uni, jitters=jitters,
    )
    device = _build.one_device("frame_kernel", tensors)
    if device.type == "cpu":
        return frame_plain(packed, uni, jitters, fs)
    Nw = packed.n_wide
    check = functools.partial(_build.check, "frame_kernel")
    check("nodes", packed.nodes, torch.float32, (Nw, WIDE, 8))
    check("leaves", packed.leaves, torch.float32, (None, LEAF_STRIDE))
    check("normals", packed.normals, torch.float32, (packed.leaves.shape[0], LEAF_STRIDE))
    check("env", packed.env, torch.float32, (None, None, TEXEL))
    check("uni", uni, torch.float32, (UNI_SIZE,))
    check("jitters", jitters, torch.float32, (None, 2))
    K = jitters.shape[0]
    if K < 1 or fs.width < 1 or fs.height < 1:
        raise ValueError("frame_kernel: need K >= 1 and a non-empty frame")
    if not 1 <= packed.stack_depth <= MAX_STACK:
        raise ValueError(f"frame_kernel: stack depth {packed.stack_depth} > {MAX_STACK}")
    if fs.phases() > MAX_PHASES:
        raise ValueError(f"frame_kernel: {fs.phases()} walk phases > {MAX_PHASES}")

    fn = _entry()
    out = torch.empty((fs.height, fs.width, 3), dtype=torch.float32, device=device)
    counters = torch.zeros(1 + 3 * fs.phases(), dtype=torch.long, device=device)
    inv_w, inv_h, aspect = _raygen_scalars(fs.width, fs.height)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            packed.nodes.data_ptr(), packed.leaves.data_ptr(), packed.normals.data_ptr(),
            packed.env.data_ptr(),
            packed.env.shape[0], packed.env.shape[1],
            uni.data_ptr(), jitters.data_ptr(), K, fs.width, fs.height,
            inv_w, inv_h, aspect,
            fs.bounce_count, int(fs.cast_shadows), int(fs.enable_diffuse),
            fs.surface_fudge, fs.mt_eps, fs.max_steps or Nw + 2,
            packed.stack_depth,
            out.data_ptr(), counters.data_ptr(), stream,
        )
    _build.launched("frame_kernel", err)
    return out, counters
