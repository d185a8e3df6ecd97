"""Renderer facade (counterpart of shader_ray_tpu/engine.py): packs the
scene onto the device — the 8-wide tables or, with
``Config.packet_kernel = "binary"``, the binary ones — and hands out
frame functions per static render configuration.  A frame function runs
the fused frame kernel once per call (wide tables, ``Config.packet_fused``,
every ``which`` but 3; ``which = 5`` over its 25 given sub-ray sets) or
the unfused trace engine; ops/engine_frame.py routes.  Every fused route
retires spent lanes at ``Config.min_contrib``, read at each call.

The device is the CUDA card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request the constructor raises.  With
``Config.validate_scene`` the constructor checks the scene's tables
(models/validate.py) before it packs them.
"""

from __future__ import annotations

import numpy as np
import torch

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.world import SceneData
from shader_ray_tpu_torch.ops.engine_frame import (
    count_cast,
    fused_route,
    halton_jitters,
    render_frame,
    render_progressive,
    tile_stats,
)
from shader_ray_tpu_torch.ops.pack import pack_scene
from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide
from shader_ray_tpu_torch.ops.render import FrameParams, RenderStatics


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
    ) -> None:
        self.device = pick_device(device)
        _true_f32()
        self.cfg = (config or Config()).validate()
        if self.cfg.validate_scene:
            from shader_ray_tpu_torch.models.validate import validate_scene_data

            validate_scene_data(data)
        pack = pack_scene_wide if self.cfg.packet_kernel == "wide" else pack_scene
        self.packed = pack(data, background, self.cfg).to(self.device)

    # the render knobs are read from the config at each call, so a live
    # edit (app.driver.App.set_knob) reaches the next frame
    @property
    def max_steps(self) -> int:
        return self.cfg.packet_max_steps

    @property
    def fused(self) -> bool:
        return self.cfg.packet_fused

    def make_fn(self, statics: RenderStatics):
        """``fn(params) -> (H, W, 3)`` one frame at params.pixel_jitter."""

        def fn(params: FrameParams) -> torch.Tensor:
            return render_frame(self.packed, params, statics, self.max_steps, self.fused,
                                self.cfg.min_contrib)

        return fn

    def make_checksum_fn(self, statics: RenderStatics):
        """``fn(params) -> scalar`` sum of the frame (a cheap fence)."""
        frame = self.make_fn(statics)
        return lambda params: frame(params).sum()

    def make_progressive_fn(self, statics: RenderStatics, samples: int, reduce_sum: bool = False):
        """``fn(params) -> (H, W, 3)``: the linear mean of ``samples``
        Halton-jittered frames, tonemapped once (ONE kernel launch on
        the fused route); ``reduce_sum`` returns its sum instead."""
        jitters = torch.from_numpy(halton_jitters(samples)).to(self.device)

        def fn(params: FrameParams) -> torch.Tensor:
            out = render_progressive(
                self.packed, params, statics, jitters, self.max_steps, self.fused,
                self.cfg.min_contrib,
            )
            return out.sum() if reduce_sum else out

        return fn

    def make_count_fn(self, statics: RenderStatics):
        """``fn(params) -> int`` rays actually cast for one frame (live
        bounce rays + shadow rays from light-facing hits), the honest
        Mrays/s denominator vs the W*H*6 potential."""

        def fn(params: FrameParams) -> int:
            return count_cast(self.packed, params, statics, self.max_steps, self.fused,
                              self.cfg.min_contrib)

        return fn

    def make_stats_fn(self, statics: RenderStatics):
        """``fn(params) -> (n_tiles, 1 + 3 * phases)`` int64 per-tile walk
        counters of one ``which = 0`` frame at params.pixel_jitter from
        the fused frame kernel, one row a 16 x 16 pixel tile: column 0
        rays cast, columns 1+3p / 2+3p / 3+3p phase p's node pops, leaf
        visits and triangle tests (``frame_kernel.stats_phases`` names
        the phases).  None where there is no fused route (binary tables,
        ``packet_fused=False``), as the reference's without the fused
        packet engine."""
        if not fused_route(self.packed, statics._replace(which=0), self.fused):
            return None

        def fn(params: FrameParams) -> torch.Tensor:
            return tile_stats(self.packed, params, statics, self.max_steps, self.cfg.min_contrib)

        return fn
