"""Frame parameters, static render configuration and pinhole ray
generation (counterpart of shader_ray_tpu/ops/render.py).

The frame kernel generates its primary rays itself from the uniform
table (ops/engine_frame.pack_uniforms); ``rays_for_pixels`` is the
batched formulation of the same pinhole camera with the seeded ray
differentials (raytracer.vs:39-58, fs:621-625, ray.cpp:677-683), which
feeds the unfused trace engine (ops/engine_trace.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.ops.shading import Rays
from shader_ray_tpu_torch.ops.vecmath import dot, normalize, transform_dir, transform_point


class FrameParams(NamedTuple):
    """Per-frame uniforms (reference ray.cpp:648-704), f32 tensors."""

    camera_matrix: torch.Tensor          # (4,4) eye->world ray transform
    camera_normal_matrix: torch.Tensor   # (4,4)
    object_matrix: torch.Tensor          # (4,4) world->object ray transform
    object_normal_matrix: torch.Tensor   # (4,4)
    object_normal_inverse: torch.Tensor  # (4,4) object->world normals
    light_dir: torch.Tensor              # (3,)
    specular_color: torch.Tensor         # (3,)
    diffuse_color: torch.Tensor          # (3,)
    image_plane_width: torch.Tensor      # () = 2*tan(fov/2)
    pixel_jitter: torch.Tensor | None = None  # (2,) sub-pixel jitter in pixels


class RenderStatics(NamedTuple):
    """Static render configuration."""

    width: int = 512
    height: int = 512
    bounce_count: int = 3
    which: int = 0               # debug mode, fs `which` uniform: 0 frame, 1
                                 # textureGrad env, 2 dY derivative, 3
                                 # differential spread, 5 5x5 supersample
    cast_shadows: bool = True
    enable_diffuse: bool = True  # fs:570 gate
    use_filmic: bool = True
    do_tonemap: bool = True
    mt_eps: float = 1.0e-7
    surface_fudge: float = 1.0e-4
    env_aniso: int = 1           # which=1 anisotropy probes (GL MAX_ANISOTROPY 4,
                                 # ray.cpp:505-508); 1 = isotropic trilinear

    @staticmethod
    def from_config(cfg: Config | None = None, **overrides) -> "RenderStatics":
        """Statics from the configured frame size, render constants and
        ``env_aniso`` (the reference's from_config, ops/render.py:87-103),
        then ``overrides``."""
        cfg = cfg or Config()
        base = dict(
            width=cfg.window_width,
            height=cfg.window_height,
            bounce_count=cfg.bounce_count,
            cast_shadows=cfg.cast_shadows,
            use_filmic=cfg.use_filmic,
            do_tonemap=cfg.do_tonemap,
            mt_eps=cfg.mt_epsilon,
            surface_fudge=cfg.surface_fudge,
            env_aniso=cfg.env_aniso,
        )
        return RenderStatics(**{**base, **overrides})


def rays_for_pixels(
    statics: RenderStatics, params: FrameParams, jj: torch.Tensor, ii: torch.Tensor
) -> tuple[Rays, tuple]:
    """Pinhole rays + seeded differentials for pixel index tensors
    (``jj`` = row from top, ``ii`` = column; f32, broadcastable).
    Returns (H*W-flattened Rays, (right, up))."""
    W, H = statics.width, statics.height
    ipw = params.image_plane_width
    aspect = H / (1.0 * W)  # ray.cpp:673
    jx = 0.0 if params.pixel_jitter is None else params.pixel_jitter[0]
    jy = 0.0 if params.pixel_jitter is None else params.pixel_jitter[1]
    u = (ii + 0.5 + jx) / W
    v = 1.0 - (jj + 0.5 + jy) / H  # v = 0 bottom (vs:43-45)
    shape = torch.broadcast_shapes(jj.shape, ii.shape)
    d_eye = torch.stack(
        [
            torch.broadcast_to(ipw * (u - 0.5), shape),
            torch.broadcast_to(ipw * (v - 0.5) * aspect, shape),
            torch.full(shape, -1.0, dtype=torch.float32, device=jj.device),
        ],
        dim=-1,
    )
    d_eye = normalize(d_eye)
    zero3 = torch.zeros(3, dtype=torch.float32, device=jj.device)
    P = torch.broadcast_to(transform_point(params.camera_matrix, zero3), shape + (3,))
    D = normalize(transform_dir(params.camera_normal_matrix, d_eye))  # fs:619

    # per-pixel world-space spacing vectors (ray.cpp:677-683)
    zero = torch.zeros((), dtype=torch.float32, device=jj.device)
    right = transform_dir(
        params.camera_normal_matrix, torch.stack([ipw / W, zero, zero])
    )
    up = transform_dir(
        params.camera_normal_matrix, torch.stack([zero, ipw * aspect / H, zero])
    )
    # dDdx = (dot(d,d)*right - dot(d,right)*d) / |d|^3 with |d| = 1
    dDdx = right - dot(D, right)[..., None] * D
    dDdy = up - dot(D, up)[..., None] * D
    flat = lambda x: x.reshape(-1, 3)
    zeros = torch.zeros((int(np.prod(shape)), 3), dtype=torch.float32, device=jj.device)
    return Rays(
        P=flat(P), D=flat(D), dPdx=zeros, dDdx=flat(dDdx), dPdy=zeros, dDdy=flat(dDdy)
    ), (right, up)


def generate_rays(statics: RenderStatics, params: FrameParams) -> Rays:
    """Per-pixel pinhole rays, (H*W, 3) row-major, row 0 = top."""
    dev = params.camera_matrix.device
    jj = torch.arange(statics.height, dtype=torch.float32, device=dev)[:, None]
    ii = torch.arange(statics.width, dtype=torch.float32, device=dev)[None, :]
    return rays_for_pixels(statics, params, jj, ii)[0]


def default_frame_params(
    statics: RenderStatics | None = None,
    fov: float = np.deg2rad(40.0),
    *,
    device: str | torch.device = "cpu",
) -> FrameParams:
    """Identity view: camera at the origin looking down -z, light
    (0,0,1), gold specular, no diffuse.  ``statics`` is the reference's
    parameter, which its params do not read either."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    eye = np.eye(4, dtype=np.float32)
    return FrameParams(
        camera_matrix=f32(eye),
        camera_normal_matrix=f32(eye),
        object_matrix=f32(eye),
        object_normal_matrix=f32(eye),
        object_normal_inverse=f32(eye),
        light_dir=f32([0.0, 0.0, 1.0]),
        specular_color=f32([1.0, 0.71, 0.29]),
        diffuse_color=f32(np.zeros(3)),
        image_plane_width=f32(2.0 * np.tan(fov / 2.0)),
        pixel_jitter=f32(np.zeros(2)),
    )
