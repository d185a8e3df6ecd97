"""Frame and progressive entry functions around the frame kernel
(counterpart of the fused paths of shader_ray_tpu/ops/engine_pallas.py:
the S = 1 branch of ``render_frame_packet`` and
``render_progressive_packet``).

One frame or a progressive batch is ONE frame-kernel launch: the kernel
averages the K jittered samples in linear space and the tonemap runs
once on the mean, in plain PyTorch, as it runs in plain XLA outside the
Pallas kernel in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from shader_ray_tpu_torch.ops.frame_kernel import (
    UNI_CAM_NORMAL,
    UNI_CAM_ORIGIN,
    UNI_DIFFUSE,
    UNI_IPW,
    UNI_LIGHT_DIR,
    UNI_NORMAL_INVERSE,
    UNI_NORMAL_MATRIX,
    UNI_OBJECT_MATRIX,
    UNI_SIZE,
    UNI_SPECULAR,
    FrameSettings,
    frame_kernel,
)
from shader_ray_tpu_torch.ops.pack_wide import PackedWide
from shader_ray_tpu_torch.ops.render import FrameParams, RenderStatics
from shader_ray_tpu_torch.ops.shading import tonemap_and_gamma
from shader_ray_tpu_torch.utils.halton import halton


def pack_uniforms(params: FrameParams) -> torch.Tensor:
    """FrameParams -> the kernel's (UNI_SIZE,) f32 uniform table
    (kernel_mega.py:43-54; engine_pallas._pack_uniforms)."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    cam = f32(params.camera_matrix)
    uni = torch.zeros(UNI_SIZE, dtype=torch.float32, device=cam.device)
    uni[UNI_OBJECT_MATRIX : UNI_OBJECT_MATRIX + 12] = f32(params.object_matrix)[:3, :4].reshape(-1)
    uni[UNI_NORMAL_MATRIX : UNI_NORMAL_MATRIX + 9] = f32(params.object_normal_matrix)[:3, :3].reshape(-1)
    uni[UNI_NORMAL_INVERSE : UNI_NORMAL_INVERSE + 9] = f32(params.object_normal_inverse)[:3, :3].reshape(-1)
    uni[UNI_LIGHT_DIR : UNI_LIGHT_DIR + 3] = f32(params.light_dir).reshape(-1)
    uni[UNI_SPECULAR : UNI_SPECULAR + 3] = f32(params.specular_color).reshape(-1)
    uni[UNI_DIFFUSE : UNI_DIFFUSE + 3] = f32(params.diffuse_color).reshape(-1)
    uni[UNI_CAM_ORIGIN : UNI_CAM_ORIGIN + 3] = cam[:3, 3]  # camera * (0,0,0,1)
    uni[UNI_CAM_NORMAL : UNI_CAM_NORMAL + 9] = f32(params.camera_normal_matrix)[:3, :3].reshape(-1)
    uni[UNI_IPW] = f32(params.image_plane_width)
    return uni


def halton_jitters(samples: int) -> np.ndarray:
    """(K, 2) sub-pixel jitters halton(s+1, 2) - 0.5, halton(s+1, 3) - 0.5
    (shader_ray_tpu/engine.py:220-224)."""
    return np.asarray(
        [[halton(s + 1, 2) - 0.5, halton(s + 1, 3) - 0.5] for s in range(samples)],
        np.float32,
    )


def frame_settings(statics: RenderStatics, max_steps: int = 0) -> FrameSettings:
    if statics.which != 0:
        raise NotImplementedError(
            f"which={statics.which}: the port renders which=0 only so far"
        )
    return FrameSettings(
        width=statics.width,
        height=statics.height,
        bounce_count=statics.bounce_count,
        cast_shadows=statics.cast_shadows,
        enable_diffuse=statics.enable_diffuse,
        surface_fudge=statics.surface_fudge,
        mt_eps=statics.mt_eps,
        max_steps=max_steps,
    )


def render_linear(
    packed: PackedWide,
    params: FrameParams,
    statics: RenderStatics,
    jitters: torch.Tensor,
    max_steps: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Linear (H, W, 3) mean over the (K, 2) jitters + the kernel's
    counter row (ops/frame_kernel.py).  The uniform table is built where
    ``params`` live (usually the host) and copied to the scene's device
    once."""
    dev = packed.leaves.device
    return frame_kernel(
        packed, pack_uniforms(params).to(dev), jitters.to(dev),
        frame_settings(statics, max_steps),
    )


def frame_jitter(params: FrameParams) -> torch.Tensor:
    """(1, 2) jitter table of a single frame at ``params.pixel_jitter``."""
    if params.pixel_jitter is None:
        return torch.zeros((1, 2), dtype=torch.float32)
    return torch.as_tensor(params.pixel_jitter, dtype=torch.float32).reshape(1, 2)


def _finish(color: torch.Tensor, statics: RenderStatics) -> torch.Tensor:
    return tonemap_and_gamma(color, statics.use_filmic) if statics.do_tonemap else color


def render_frame(
    packed: PackedWide, params: FrameParams, statics: RenderStatics, max_steps: int = 0
) -> torch.Tensor:
    """One frame at ``params.pixel_jitter`` -> (H, W, 3), tonemapped
    unless ``statics.do_tonemap`` is off."""
    color, _ = render_linear(packed, params, statics, frame_jitter(params), max_steps)
    return _finish(color, statics)


def render_progressive(
    packed: PackedWide,
    params: FrameParams,
    statics: RenderStatics,
    jitters: torch.Tensor,
    max_steps: int = 0,
) -> torch.Tensor:
    """Mean of K frames at the (K, 2) jitters in linear space, tonemapped
    once -> (H, W, 3)."""
    return _finish(render_linear(packed, params, statics, jitters, max_steps)[0], statics)
