"""The unfused trace engine: the 3-bounce trace loop over a batch of
rays given as tensors (counterpart of
shader_ray_tpu/ops/engine_pallas.trace_rays_packet with ``fused=False``
and of ``_env_lookup``).

Per bounce one closest-hit trace and, for light-facing hits, one any-hit
shadow trace through ``ops/trace_kernel.trace`` — the table type picks
the 8-wide or the binary kernel — with plain elementwise shading
(ops/shading.py, ops/vecmath.py) and ray-differential transport between
them, then the environment term through ``ops/env_kernel.env_sample``.
It is the A/B engine for the fused frame kernel (``packet_fused=False``,
every ``which``), the only engine for binary tables, and the engine of
the supersample oracle ``which = 5`` (its 25 sub-frames looped by
ops/engine_frame.py), whose rays are given, not generated.
"""

from __future__ import annotations

import torch

from shader_ray_tpu_torch.ops.env_kernel import env_sample
from shader_ray_tpu_torch.ops.envmap import EnvPyramid, dy_picture
from shader_ray_tpu_torch.ops.pack import PackedBinary
from shader_ray_tpu_torch.ops.pack_wide import PackedWide
from shader_ray_tpu_torch.ops.render import FrameParams, RenderStatics
from shader_ray_tpu_torch.ops.shading import Rays, f_schlick_vr, ray_reflect, ray_transfer
from shader_ray_tpu_torch.ops.trace_kernel import INFINITELY_FAR, trace
from shader_ray_tpu_torch.ops.vecmath import dot, transform_dir, transform_point


def env_lookup(
    env: EnvPyramid, statics: RenderStatics, D: torch.Tensor,
    dDdx: torch.Tensor, dDdy: torch.Tensor,
) -> torch.Tensor:
    """The environment term for the final rays, per debug mode: mode 1
    textureGrad trilinear with ``statics.env_aniso`` probes (fs:146);
    mode 2 the dY differential visualization (fs:147-149), no lookup;
    any other mode level-0 bilinear (fs:153)."""
    if statics.which == 2:
        return dy_picture(D, dDdx, dDdy)
    if statics.which == 1:
        return env_sample(
            env, D.contiguous(), dDdx.contiguous(), dDdy.contiguous(),
            grad=True, aniso=statics.env_aniso,
        )
    return env_sample(env, D.contiguous())


def trace_rays(
    packed: PackedWide | PackedBinary,
    rays: Rays,
    params: FrameParams,
    statics: RenderStatics,
    max_steps: int = 0,
    with_counts: bool = False,
):
    """The bounce loop over a full ray batch -> linear colour (R, 3).
    ``with_counts`` also returns the rays actually cast (live bounce
    rays + shadow rays from light-facing hits) as an int64 scalar
    tensor.  ``params`` live on the rays' device."""
    R = rays.P.shape[0]
    dev = rays.P.device
    accumulated = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    modulation = torch.ones((R, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    bad = torch.zeros(R, dtype=torch.bool, device=dev)
    cast = torch.zeros((), dtype=torch.long, device=dev)
    r = rays

    # the rays of a whole frame are its pixels, row-major: the kernels
    # then walk them in 2D tiles
    width = statics.width if R == statics.width * statics.height else 0

    def cast_rays(P, D, active, any_hit=False):
        return trace(packed, P.contiguous(), D.contiguous(), active, any_hit=any_hit,
                     mt_eps=statics.mt_eps, max_steps=max_steps, width=width)

    for _ in range(statics.bounce_count):
        cast = cast + alive.sum()
        objP = transform_point(params.object_matrix, r.P)
        objD = transform_dir(params.object_normal_matrix, r.D)
        hit = cast_rays(objP, objD, alive)
        missed = hit.t >= INFINITELY_FAR
        bad = bad | (alive & hit.bad)
        hit_ok = alive & ~hit.bad & ~missed

        world_n = transform_dir(params.object_normal_inverse, hit.normal)
        world_n = torch.where((dot(world_n, r.D) > 0.0)[..., None], -world_n, world_n)

        transferred = ray_transfer(r, hit.t, world_n)
        reflected = ray_reflect(transferred, world_n, statics.surface_fudge)
        spec = f_schlick_vr(params.specular_color, r.D, reflected.D)

        if statics.enable_diffuse:
            lcos = torch.clamp(dot(world_n, params.light_dir), min=0.0)
            if statics.cast_shadows:
                # light-facing hits only (lcos == 0 adds no diffuse either
                # way; output-identical to the unconditional cast of
                # fs:454-464)
                sact = hit_ok & (lcos > 0.0)
                cast = cast + sact.sum()
                sP = transform_point(params.object_matrix, reflected.P)
                sD = transform_dir(
                    params.object_normal_matrix, params.light_dir.expand(R, 3)
                )
                shadow = cast_rays(sP, sD, sact, any_hit=True)
                lit = shadow.t >= INFINITELY_FAR
            else:
                lit = torch.ones(R, dtype=torch.bool, device=dev)
            irradiance = (lcos * lit)[..., None]
            accumulated = torch.where(
                hit_ok[..., None],
                accumulated + modulation * params.diffuse_color * irradiance,
                accumulated,
            )

        modulation = torch.where(hit_ok[..., None], modulation * spec, modulation)
        r = Rays(*[torch.where(hit_ok[..., None], new, old) for new, old in zip(reflected, r)])
        alive = hit_ok

    env = env_lookup(packed.env_pyramid, statics, r.D, r.dDdx, r.dDdy)
    color = accumulated + modulation * env
    red = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    color = torch.where(bad[..., None], red, color)
    if with_counts:
        return color, cast
    return color
