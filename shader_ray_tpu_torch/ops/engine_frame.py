"""Frame and progressive entry functions (counterpart of
shader_ray_tpu/ops/engine_pallas.render_frame_packet and
render_progressive_packet).

Routing is by configuration, decided in ``fused_route``:

* every ``which`` but 3, ``fused`` and wide tables: the fused frame
  kernel (ops/frame_kernel.py), as the reference runs ``which`` 0, 1, 2
  and 5 in its fused kernel (engine_pallas.py:229-239, :555, :606-612,
  :755-760).  One frame or a progressive batch is ONE launch; the kernel
  averages the K jittered samples in linear space.  ``which = 1`` and
  ``2`` run its ``with_grads`` form (ray differentials, textureGrad env
  or the dY picture).  ``which = 5`` (the supersample oracle, fs:654-673)
  builds the 25 sub-sample directions from the primary rays
  (``supersample_directions``) and runs them as ONE launch of the
  kernel's given-rays form, K = 25, bilinear env: the mean of the 25
  sets is the reference's ``acc / (n * n)`` (engine_pallas.py:665-702).
  ``min_contrib`` > 0 retires spent lanes in the kernel (Config.
  min_contrib, as the reference's packet_shade reads it).
* ``fused=False`` or binary tables: primary rays as tensors
  (``generate_rays``) through the unfused trace engine
  (ops/engine_trace.py), every ``which``, ``which = 5`` as 25 sub-frames
  over the same directions; this route ignores ``min_contrib``, as the
  reference's unfused loop does.
* ``which = 3``: pure math on the primary rays, no trace (fs:642-650).
* any other ``which`` renders as ``which = 0`` does, as in the reference.

``tile_stats`` is the stats fn's frame: the fused kernel's counter row
of each pixel tile of a ``which = 0`` frame.

Every fused route launches the kernel in the tile shape of ``tile_w``
and ``warp_map`` (``Config.frame_tile`` and ``frame_warp``, read by the
Renderer at each call; 16 x 16 tiles in rows by default): the frame is
the same under each, and ``tile_stats``' rows follow the tiles.

``render_linear(rows=(r0, r1))`` renders only image rows r0 to r1 - 1
(a shard of parallel/mesh.shard_rows), each ray the whole frame's: on the
fused route through the kernel's given-rays form over ``raygen_rays``
(``fused_given``), elsewhere by the same functions over those rows.

A progressive batch renders its K frames one after the other and sums
them in order, except on the fused route outside ``which = 5``, where it
is one launch.  The tonemap runs once on the linear mean, in plain
PyTorch, as it runs in plain XLA outside the Pallas kernels in the
reference.
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
    TILE,
    UNI_SIZE,
    UNI_SPECULAR,
    FrameSettings,
    GivenRays,
    frame_kernel,
    raygen_rays,
)
from shader_ray_tpu_torch.ops.engine_trace import trace_rays
from shader_ray_tpu_torch.ops.envmap import env_coords
from shader_ray_tpu_torch.ops.pack import PackedBinary
from shader_ray_tpu_torch.ops.pack_wide import PackedWide
from shader_ray_tpu_torch.ops.render import (
    FrameParams,
    RenderStatics,
    generate_rays,
    rays_for_pixels,
)
from shader_ray_tpu_torch.ops.shading import Rays, tonemap_and_gamma
from shader_ray_tpu_torch.ops.vecmath import dot, normalize
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


SUPERSAMPLE = 5  # which=5 sub-samples per axis (fs:654-673)

Packed = PackedWide | PackedBinary


def fused_route(packed: Packed, statics: RenderStatics, fused: bool) -> bool:
    """Whether this configuration renders through the fused frame
    kernel (module docstring)."""
    return fused and isinstance(packed, PackedWide) and statics.which != 3


def frame_settings(
    statics: RenderStatics, max_steps: int = 0, min_contrib: float = 0.0,
    tile_w: int = TILE, warp_map: str = "rows",
) -> FrameSettings:
    """The fused frame kernel's settings.  ``which = 3`` traces nothing
    and must not arrive here; ``which = 5`` is the bilinear mode over
    given rays (``fused_supersample``); a ``which`` the kernel does not
    know renders as 0."""
    if statics.which == 3:
        raise NotImplementedError(
            "which=3 is not a mode of the fused frame kernel; it is math on the "
            "primary rays in unfused_linear (render_linear routes it there)"
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
        which=statics.which if statics.which in (1, 2) else 0,
        env_aniso=statics.env_aniso,
        min_contrib=min_contrib,
        tile_w=tile_w,
        warp_map=warp_map,
    )


def _on(params: FrameParams, device) -> FrameParams:
    return FrameParams(*[None if x is None else torch.as_tensor(x).to(device) for x in params])


def primary_rays(
    statics: RenderStatics, params: FrameParams, rows: tuple[int, int] | None = None
) -> tuple[Rays, tuple]:
    """The frame's pinhole rays at ``params.pixel_jitter`` where the
    params live, (H*W, 3) row-major, and the pixel spacing (right, up);
    with ``rows`` = (r0, r1) only image rows r0 to r1 - 1, each ray the
    whole frame's."""
    dev = params.camera_matrix.device
    r0, r1 = rows or (0, statics.height)
    jj = torch.arange(r0, r1, dtype=torch.float32, device=dev)[:, None]
    ii = torch.arange(statics.width, dtype=torch.float32, device=dev)[None, :]
    return rays_for_pixels(statics, params, jj, ii)


def unfused_linear(
    packed: Packed, params: FrameParams, statics: RenderStatics, max_steps: int = 0,
    rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """One frame at ``params.pixel_jitter`` off the fused route: linear
    (H, W, 3) colour, or (r1 - r0, W, 3) of image ``rows`` (r0, r1)."""
    params = _on(params, packed.env_pyramid.texels.device)
    rays, (right, up) = primary_rays(statics, params, rows)
    if statics.which == 3:
        # this pixel's env-coordinate differentials (fs:642-650)
        below = torch.stack(env_coords(rays.D - rays.dDdy / 2.0), dim=-1)
        above = torch.stack(env_coords(rays.D + rays.dDdy / 2.0), dim=-1)
        delta = torch.abs(above - below) * 100.0
        color = torch.cat([delta, torch.zeros_like(delta[..., :1])], dim=-1)
    elif statics.which == 5:
        color = torch.zeros_like(rays.P)
        zeros = torch.zeros_like(rays.P)
        for Ds in supersample_directions(rays.D, right, up):
            sub = Rays(
                P=rays.P, D=Ds, dPdx=zeros, dDdx=right - dot(Ds, right)[..., None] * Ds,
                dPdy=zeros, dDdy=up - dot(Ds, up)[..., None] * Ds,
            )
            color = color + trace_rays(packed, sub, params, statics, max_steps)
        color = color / SUPERSAMPLE**2
    else:
        color = trace_rays(packed, rays, params, statics, max_steps)
    return color.reshape(-1, statics.width, 3)


def supersample_directions(D: torch.Tensor, right: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """(25, N, 3): the which = 5 sub-sample directions of the (N, 3)
    primary directions, set i * 5 + j offset by (i / 5 - 0.5, j / 5 -
    0.5) x 0.2 pixel spacings (fs:654-673, engine_pallas.py:686-699)."""
    n = SUPERSAMPLE
    offs = torch.tensor([[(i / n - 0.5) * 0.2, (j / n - 0.5) * 0.2] for i in range(n)
                         for j in range(n)], dtype=torch.float32, device=D.device)
    return normalize(D + offs[:, 0, None, None] * right + offs[:, 1, None, None] * up)


def fused_linear(
    packed: PackedWide, params: FrameParams, statics: RenderStatics,
    jitters: torch.Tensor, max_steps: int = 0, min_contrib: float = 0.0,
    tile_w: int = TILE, warp_map: str = "rows",
) -> tuple[torch.Tensor, torch.Tensor]:
    """ONE frame-kernel launch: the linear (H, W, 3) mean over the
    (K, 2) jitters + the kernel's counter row (ops/frame_kernel.py).  The
    uniform table is built where ``params`` live (usually the host) and
    copied to the scene's device once."""
    dev = packed.leaves.device
    return frame_kernel(
        packed, pack_uniforms(params).to(dev), jitters.to(dev),
        frame_settings(statics, max_steps, min_contrib, tile_w, warp_map),
    )


def fused_supersample(
    packed: PackedWide, params: FrameParams, statics: RenderStatics,
    max_steps: int = 0, min_contrib: float = 0.0, rows: tuple[int, int] | None = None,
    tile_w: int = TILE, warp_map: str = "rows",
) -> torch.Tensor:
    """The which = 5 frame at ``params.pixel_jitter`` as ONE launch of
    the frame kernel's given-rays form: the primaries' origins and their
    25 sub-sample direction sets, built on the scene's device; the
    linear (H, W, 3) mean of the 25 sub-frames, or (r1 - r0, W, 3) of
    image ``rows`` (r0, r1)."""
    params = _on(params, packed.leaves.device)
    rays, (right, up) = primary_rays(statics, params, rows)
    given = GivenRays(P=rays.P.contiguous(), D=supersample_directions(rays.D, right, up))
    fs = frame_settings(statics, max_steps, min_contrib, tile_w, warp_map)
    return frame_kernel(packed, pack_uniforms(params), None,
                        fs._replace(height=rays.P.shape[0] // fs.width), rays=given)[0]


def fused_given(
    packed: PackedWide, params: FrameParams, statics: RenderStatics, jitters: torch.Tensor,
    rows: tuple[int, int], max_steps: int = 0, min_contrib: float = 0.0,
    tile_w: int = TILE, warp_map: str = "rows",
) -> torch.Tensor:
    """Image ``rows`` (r0, r1) of the fused frame over the (K, 2)
    ``jitters`` as ONE launch of the frame kernel's given-rays form: the
    rays its raygen would make for those rows (``raygen_rays``, with
    their differentials in the grad modes), built on the scene's device;
    the linear (r1 - r0, W, 3) mean.  Rows (0, H) give the whole frame's
    given-rays form."""
    dev = packed.leaves.device
    uni = pack_uniforms(params).to(dev)
    fs = frame_settings(statics, max_steps, min_contrib, tile_w, warp_map)
    rays = raygen_rays(uni, jitters.to(dev), fs, rows)
    return frame_kernel(packed, uni, None, fs._replace(height=rows[1] - rows[0]), rays=rays)[0]


def render_linear(
    packed: Packed,
    params: FrameParams,
    statics: RenderStatics,
    jitters: torch.Tensor,
    max_steps: int = 0,
    fused: bool = True,
    min_contrib: float = 0.0,
    rows: tuple[int, int] | None = None,
    tile_w: int = TILE,
    warp_map: str = "rows",
) -> torch.Tensor:
    """Linear (H, W, 3) mean over the (K, 2) jitters, by the route of
    the configuration (module docstring); with ``rows`` = (r0, r1) the
    (r1 - r0, W, 3) band of those image rows, on the fused route through
    the kernel's given-rays form (``fused_given``), elsewhere the same
    function as the whole frame's."""
    on_kernel = fused_route(packed, statics, fused)
    shape = dict(tile_w=tile_w, warp_map=warp_map)
    if on_kernel and statics.which != 5:
        if rows is not None:
            return fused_given(packed, params, statics, jitters, rows, max_steps, min_contrib, **shape)
        return fused_linear(packed, params, statics, jitters, max_steps, min_contrib, **shape)[0]
    total = None
    for jit in jitters:
        jittered = params._replace(pixel_jitter=jit)
        frame = (fused_supersample(packed, jittered, statics, max_steps, min_contrib, rows, **shape)
                 if on_kernel else unfused_linear(packed, jittered, statics, max_steps, rows))
        total = frame if total is None else total + frame
    return total / jitters.shape[0]


def count_cast(
    packed: Packed, params: FrameParams, statics: RenderStatics,
    max_steps: int = 0, fused: bool = True, min_contrib: float = 0.0,
    tile_w: int = TILE, warp_map: str = "rows",
) -> int:
    """Rays actually cast for one frame at ``params.pixel_jitter``: live
    bounce rays + shadow rays from light-facing hits.  It is one trace of
    the primary rays, whatever ``which``: the fused route counts the
    ``which = 0`` frame at ``which = 5`` (shader_ray_tpu/engine.py:339-371)."""
    if fused_route(packed, statics, fused):
        if statics.which == 5:
            statics = statics._replace(which=0)
        return int(fused_linear(packed, params, statics, frame_jitter(params), max_steps,
                                min_contrib, tile_w, warp_map)[1][0])
    params = _on(params, packed.env_pyramid.texels.device)
    rays = generate_rays(statics, params)
    return int(trace_rays(packed, rays, params, statics, max_steps, with_counts=True)[1])


def tile_stats(
    packed: PackedWide, params: FrameParams, statics: RenderStatics, max_steps: int = 0,
    min_contrib: float = 0.0, tile_w: int = TILE, warp_map: str = "rows",
) -> torch.Tensor:
    """The per-tile counter rows of one ``which = 0`` frame at
    ``params.pixel_jitter`` through the fused frame kernel:
    (n_tiles, 1 + 3 * phases) int64, one row a tile of ``tile_w`` x
    256 / ``tile_w`` pixels, tiles row-major.  Column 0 rays cast; columns 1+3p, 2+3p, 3+3p phase
    p's node pops, leaf visits and triangle tests (phases in
    ``frame_kernel.stats_phases`` order), summed over the tile's rays."""
    fs = frame_settings(statics._replace(which=0), max_steps, min_contrib, tile_w, warp_map)
    dev = packed.leaves.device
    rows = torch.empty((fs.n_tiles(), 1 + 3 * fs.phases()), dtype=torch.long, device=dev)
    frame_kernel(packed, pack_uniforms(params).to(dev), frame_jitter(params).to(dev), fs,
                 tile_rows=rows)
    return rows


def frame_jitter(params: FrameParams) -> torch.Tensor:
    """(1, 2) jitter table of a single frame at ``params.pixel_jitter``."""
    if params.pixel_jitter is None:
        return torch.zeros((1, 2), dtype=torch.float32)
    return torch.as_tensor(params.pixel_jitter, dtype=torch.float32).reshape(1, 2)


def finish(color: torch.Tensor, statics: RenderStatics) -> torch.Tensor:
    """The tonemap of a linear frame, unless ``statics.do_tonemap`` is off."""
    return tonemap_and_gamma(color, statics.use_filmic) if statics.do_tonemap else color


def render_frame(
    packed: Packed, params: FrameParams, statics: RenderStatics, max_steps: int = 0,
    fused: bool = True, min_contrib: float = 0.0, tile_w: int = TILE, warp_map: str = "rows",
) -> torch.Tensor:
    """One frame at ``params.pixel_jitter`` -> (H, W, 3), tonemapped
    unless ``statics.do_tonemap`` is off."""
    color = render_linear(packed, params, statics, frame_jitter(params), max_steps, fused,
                          min_contrib, tile_w=tile_w, warp_map=warp_map)
    return finish(color, statics)


def render_progressive(
    packed: Packed,
    params: FrameParams,
    statics: RenderStatics,
    jitters: torch.Tensor,
    max_steps: int = 0,
    fused: bool = True,
    min_contrib: float = 0.0,
    tile_w: int = TILE,
    warp_map: str = "rows",
) -> torch.Tensor:
    """Mean of K frames at the (K, 2) jitters in linear space, tonemapped
    once -> (H, W, 3)."""
    return finish(render_linear(packed, params, statics, jitters, max_steps, fused, min_contrib,
                                tile_w=tile_w, warp_map=warp_map), statics)
