"""Renderer facade (counterpart of shader_ray_tpu/engine.py): packs the
scene onto the device — the 8-wide tables or, with
``Config.packet_kernel = "binary"``, the binary ones — and hands out
frame functions per static render configuration.  A frame function runs
the fused frame kernel once per call (wide tables, ``Config.packet_fused``,
every ``which`` but 3; ``which = 5`` over its 25 given sub-ray sets) or
the unfused trace engine; ops/engine_frame.py routes.  Each call hands
the routes ``self.cfg`` as it stands then, so a live edit reaches the
next frame, and a ``copy.copy`` of a Renderer with another ``cfg``
renders the same tables under that config's knobs (utils/autotune.py
measures so).

The device is the CUDA card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request the constructor raises.  With
``Config.validate_scene`` the constructor checks the scene's tables
(models/validate.py) before it packs them.

With a ``mesh`` (parallel/mesh.py: an ordered device list, or N for the
first N cards) the tables are replicated to each device; ``make_fn`` and
``make_checksum_fn`` shard the frame's rays over bands of image rows
(the fused route through the frame kernel's given-rays form, as the
reference turns in-kernel raygen off under a mesh, engine_pallas.py:
382-388), ``make_progressive_fn`` shards its K samples when K % n == 0
(else its rays), and ``make_count_fn`` and ``make_stats_fn`` stay on
``mesh[0]``, as the reference's do.

Every function handed out is wrapped (``_wrap``, the reference's
``_cfg_wrap``, engine.py:106-129) in the span ``engine.frame``
(utils/profiling.span; the constructor's are ``renderer.pack`` and
``renderer.upload``): a kernel's build or launch failure
prints the diagnostic of utils/kerneldiag.py before it is re-raised, and
under ``Config.debug_nans`` (read at each call) an output holding a NaN
raises ``FloatingPointError`` naming the function, the counterpart of
``jax_debug_nans`` for hand-written kernels.  Red budget-overflow paint
is not NaN; a grad-mode ray exactly along +-y is, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.world import SceneData
from shader_ray_tpu_torch.ops.engine_frame import (
    count_cast,
    finish,
    frame_jitter,
    frame_settings,
    fused_route,
    halton_jitters,
    render_frame,
    render_linear,
    render_progressive,
    tile_stats,
)
from shader_ray_tpu_torch.ops.pack import pack_scene
from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide
from shader_ray_tpu_torch.ops.render import FrameParams, RenderStatics
from shader_ray_tpu_torch.utils.profiling import span


def pick_device(device: str | torch.device | None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the renderer runs on the card; pass "
                "device='cpu' to render with the plain PyTorch path"
            )
        device = "cuda"
    return torch.device(device)


def _true_f32() -> None:
    """Camera and object transforms must stay true f32 (TF32 would warp
    rays as bf16 did on the TPU, ROADMAP 8f00d1f)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 could not be disabled")


class Renderer:
    def __init__(
        self,
        data: SceneData,
        background: np.ndarray,
        config: Config | None = None,
        device: str | torch.device | None = None,
        mesh=None,
    ) -> None:
        if mesh is not None:
            from shader_ray_tpu_torch.parallel import make_mesh

            mesh = make_mesh(mesh)
            if device is not None and make_mesh([device]) != mesh[:1]:
                raise ValueError(f"device {device} is not the mesh's first device {mesh[0]}")
            device = mesh[0]
        self.device = pick_device(device)
        self.mesh = mesh
        _true_f32()
        self.cfg = (config or Config()).validate()
        if self.cfg.validate_scene:
            from shader_ray_tpu_torch.models.validate import validate_scene_data

            validate_scene_data(data)
        pack = pack_scene_wide if self.cfg.packet_kernel == "wide" else pack_scene
        with span("renderer.pack"):
            packed = pack(data, background, self.cfg)
        with span("renderer.upload"):
            self.packed = packed.to(self.device)
        self.replicas = None
        if mesh is not None:
            from shader_ray_tpu_torch.parallel import replicate_scene

            self.replicas = replicate_scene(self.packed, mesh)

    def _wrap(self, fn, label: str, statics: RenderStatics):
        """``fn`` with the failure dump and ``Config.debug_nans`` (module
        docstring)."""

        def wrapped(params: FrameParams):
            with span("engine.frame"):
                try:
                    out = fn(params)
                except Exception as e:
                    from shader_ray_tpu_torch.utils.kerneldiag import report_failure

                    report_failure(e, cfg=self.cfg, packed=self.packed,
                                   settings=self._settings(statics), label=label,
                                   device=self.mesh or self.device)
                    raise
                if self.cfg.debug_nans and isinstance(out, torch.Tensor) and \
                        out.is_floating_point() and bool(torch.isnan(out).any()):
                    raise FloatingPointError(f"{label}: NaN in its output (Config.debug_nans)")
                return out

        return wrapped

    def _settings(self, statics: RenderStatics):
        """What the dump shows of a function's kernel settings: the frame
        kernel's ``FrameSettings`` on the fused route, else the unfused
        route's trace and env settings."""
        if fused_route(self.packed, statics, self.cfg):
            return frame_settings(statics, self.cfg)
        return dict(route="unfused", tables=type(self.packed).__name__, which=statics.which,
                    width=statics.width, height=statics.height, bounce_count=statics.bounce_count,
                    cast_shadows=statics.cast_shadows, mt_eps=statics.mt_eps,
                    max_steps=self.cfg.packet_max_steps, env_aniso=statics.env_aniso)

    def _sharded_linear(self, params: FrameParams, statics: RenderStatics,
                        jitters: torch.Tensor) -> torch.Tensor:
        """Ray sharding over the mesh: the linear mean over ``jitters`` of
        each device's band of rows, gathered on ``mesh[0]``."""
        from shader_ray_tpu_torch.parallel import shard_rows

        return shard_rows(self.replicas, self.mesh, statics.height, lambda packed, rows: render_linear(
            packed, params, statics, jitters, self.cfg, rows))

    def make_fn(self, statics: RenderStatics):
        """``fn(params) -> (H, W, 3)`` one frame at params.pixel_jitter;
        ray-sharded under a mesh."""

        def fn(params: FrameParams) -> torch.Tensor:
            if self.mesh is not None:
                return finish(self._sharded_linear(params, statics, frame_jitter(params)), statics)
            return render_frame(self.packed, params, statics, self.cfg)

        return self._wrap(fn, "frame fn", statics)

    def make_checksum_fn(self, statics: RenderStatics):
        """``fn(params) -> scalar`` sum of the frame (a cheap fence)."""
        frame = self.make_fn(statics)
        return lambda params: frame(params).sum()

    def make_progressive_fn(self, statics: RenderStatics, samples: int, reduce_sum: bool = False):
        """``fn(params) -> (H, W, 3)``: the linear mean of ``samples``
        Halton-jittered frames, tonemapped once (ONE kernel launch on
        the fused route); ``reduce_sum`` returns its sum instead.  Under
        a mesh of n devices the samples are sharded when n divides them
        (each device one launch over its block), else the rays."""
        jitters = torch.from_numpy(halton_jitters(samples)).to(self.device)
        sample_shards = self.mesh is not None and samples % len(self.mesh) == 0

        def fn(params: FrameParams) -> torch.Tensor:
            if sample_shards:
                from shader_ray_tpu_torch.parallel import sample_sharded

                out = finish(sample_sharded(self.replicas, self.mesh, jitters, lambda packed, block: render_linear(
                    packed, params, statics, block, self.cfg)), statics)
            elif self.mesh is not None:
                out = finish(self._sharded_linear(params, statics, jitters), statics)
            else:
                out = render_progressive(self.packed, params, statics, jitters, self.cfg)
            return out.sum() if reduce_sum else out

        kind = "sample-sharded " if sample_shards else ""
        return self._wrap(fn, f"{kind}progressive fn (K={samples})", statics)

    def make_count_fn(self, statics: RenderStatics):
        """``fn(params) -> int`` rays actually cast for one frame (live
        bounce rays + shadow rays from light-facing hits), the honest
        Mrays/s denominator vs the W*H*6 potential."""

        def fn(params: FrameParams) -> int:
            return count_cast(self.packed, params, statics, self.cfg)

        return self._wrap(fn, "cast-count fn", statics)

    def make_stats_fn(self, statics: RenderStatics):
        """``fn(params) -> (n_tiles, 1 + 3 * phases)`` int64 per-tile walk
        counters of one ``which = 0`` frame at params.pixel_jitter from
        the fused frame kernel, one row a pixel tile of the launch shape
        (``Config.frame_tile`` wide, 16 x 16 by default): column 0
        rays cast, columns 1+3p / 2+3p / 3+3p phase p's node pops, leaf
        visits and triangle tests (``frame_kernel.stats_phases`` names
        the phases).  None where there is no fused route (binary tables,
        ``packet_fused=False``), as the reference's without the fused
        packet engine."""
        if not fused_route(self.packed, statics._replace(which=0), self.cfg):
            return None

        def fn(params: FrameParams) -> torch.Tensor:
            return tile_stats(self.packed, params, statics, self.cfg)

        return self._wrap(fn, "stats fn", statics._replace(which=0))
