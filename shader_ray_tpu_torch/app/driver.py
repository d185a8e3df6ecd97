"""Interaction state machine + frame dispatch (counterpart of
shader_ray_tpu/app/driver.py; the reference's GLFW app state,
ray.cpp:719-943, 1076-1148).

The same keyboard/mouse semantics drive the Renderer's frame functions
instead of a GL draw.  Damage-driven like the reference (`redraw_window`,
ray.cpp:1132-1142): state changes mark the frame dirty, ``render()``
recomputes only then.  Per-frame state (matrices, light, material
colors, fov) goes in as ``FrameParams`` tensors built on the host; the
Renderer moves them to its device.  A frame function is made once per
(which, size) and kept; ``set_knob`` and ``tune`` drop them.

``frames`` counts the frames drawn; it is the frame id of their spans
(utils/profiling.span: ``app.drag``, ``app.frame_params``, ``app.copy``
and the Renderer's inside), a drag's the frame it leads to.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from enum import Enum

import numpy as np
import torch

from shader_ray_tpu_torch.app import camera as cam
from shader_ray_tpu_torch.app.materials import DIFFUSE_COLORS, MATERIALS, resolve_material
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.world import World
from shader_ray_tpu_torch.ops import _build
from shader_ray_tpu_torch.ops.frame_kernel import stats_phases
from shader_ray_tpu_torch.ops.render import FrameParams, RenderStatics
from shader_ray_tpu_torch.utils import mat4
from shader_ray_tpu_torch.utils.ppm import write_ppm
from shader_ray_tpu_torch.utils.profiling import set_frame, span


class MotionTarget(Enum):
    """What a mouse drag moves (reference enum ray.cpp:724-727)."""

    OBJECT = 0
    LIGHT = 1


class App:
    # knobs read when the scene is packed (Renderer construction): a live
    # edit cannot reach the packed scene
    _PACK_TIME_KNOBS = frozenset({
        "bvh_leaf_max", "bvh_max_depth", "sah_ctrav", "sah_cisec",
        "colors_are_linear", "geometry_scale", "screen_gamma",
        "max_leaf_tests", "env_base", "packet_kernel", "splits", "bvh_opt",
        "scene_cache", "validate_scene", "use_native", "collapse", "leaf_isect",
    })

    def __init__(
        self,
        world: World,
        renderer,
        config: Config | None = None,
        width: int | None = None,
        height: int | None = None,
    ) -> None:
        cfg = config or renderer.cfg
        self.cfg = cfg
        self.world = world
        self.renderer = renderer
        self.width = width or cfg.window_width
        self.height = height or cfg.window_height

        # interaction state (reference globals, ray.cpp:35-74,724-727)
        self.fov = mat4.to_radians(cfg.fov_degrees)
        self.zoom = cam.initial_zoom(world.scene_extent, self.fov)
        self.object_rotation = np.zeros(4, dtype=np.float32)
        self.object_position = np.zeros(3, dtype=np.float32)
        self.light_rotation = cam.initial_light_rotation()
        self.light_dir = np.zeros(3, dtype=np.float32)
        self.which = 0
        self.which_material = 0
        self.which_diffuse_color = 0
        self.motion_target = MotionTarget.OBJECT
        self.redraw = True
        self.quit = False
        self.do_benchmark = False

        # mouse state (ray.cpp:862-918)
        self._button_pressed = False
        self._shift_pressed = False
        self._ox = 0.0
        self._oy = 0.0
        self._motion_reported = False

        self._fn_cache: dict[tuple, object] = {}
        self._frame: np.ndarray | None = None
        self.frames = 0

        cam.update_view_params(self.world, self.zoom, self.object_rotation, self.object_position)
        self.light_dir = cam.update_light(self.light_rotation)

    # --- frame dispatch (reference DrawFrame, ray.cpp:591-717) --------

    def _statics(self) -> RenderStatics:
        return RenderStatics.from_config(
            self.cfg, width=self.width, height=self.height, which=self.which
        )

    def _cached(self, key: tuple, make):
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = self._fn_cache[key] = make()
        return fn

    def _render_fn(self):
        return self._cached((self.which, self.width, self.height),
                            lambda: self.renderer.make_fn(self._statics()))

    def _sync(self) -> None:
        """Wait for the frame on every card of the renderer (its mesh's)."""
        for device in dict.fromkeys(self.renderer.mesh or [self.renderer.device]):
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    def frame_params(self) -> FrameParams:
        """The frame's uniforms as f32 tensors on the host."""
        with span("app.frame_params"):
            spec, diff = resolve_material(self.which_material, self.which_diffuse_color)
            w = self.world
            f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
            return FrameParams(
                camera_matrix=f32(w.camera_matrix),
                camera_normal_matrix=f32(w.camera_normal_matrix),
                object_matrix=f32(w.object_matrix),
                object_normal_matrix=f32(w.object_normal_matrix),
                object_normal_inverse=f32(w.object_normal_inverse),
                light_dir=f32(self.light_dir),
                specular_color=f32(spec),
                diffuse_color=f32(diff),
                image_plane_width=f32(2.0 * np.tan(self.fov / 2.0)),
            )

    def _to_host(self, fn) -> np.ndarray:
        """Draw the next frame with ``fn`` and copy it to the host.  A
        frame on a card goes in one copy, ordered on the card's current
        stream, into page-locked memory of its own (served by PyTorch's
        caching host allocator; the returned array holds the block, so no
        later frame overwrites it); a frame on the CPU is returned as it
        is.  ``_build.LAUNCHES`` counts each frame's route,
        ``copy_to_host:pinned`` or ``copy_to_host:plain``."""
        self.frames += 1
        set_frame(self.frames)
        out = fn(self.frame_params())
        with span("app.copy"):
            if out.device.type == "cuda":
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                torch.cuda.current_stream(out.device).synchronize()
                _build.LAUNCHES["copy_to_host:pinned"] += 1
            else:
                host = out.cpu()
                _build.LAUNCHES["copy_to_host:plain"] += 1
            self._frame = host.numpy()
        return self._frame

    def draw_frame(self) -> np.ndarray:
        return self._to_host(self._render_fn())

    def render(self) -> np.ndarray | None:
        """Damage-driven render: computes a frame only if state changed
        since the last one (ray.cpp:1132-1142)."""
        if not self.redraw and self._frame is not None:
            return None
        frame = self.draw_frame()
        self.redraw = False
        return frame

    def render_progressive(self, samples: int = 4) -> np.ndarray:
        """The linear mean of ``samples`` Halton-jittered frames,
        tonemapped once (Renderer.make_progressive_fn: one launch on the
        fused route)."""
        key = ("progressive", samples, self.which, self.width, self.height)
        fn = self._cached(key, lambda: self.renderer.make_progressive_fn(self._statics(), samples))
        self._to_host(fn)
        self.redraw = False
        return self._frame

    def walk_stats(self, file=sys.stdout) -> np.ndarray | None:
        """Render once with the frame kernel's per-tile counters and print,
        for each bounce and shadow walk, the node pops, leaf visits and
        triangle tests a tile of the launch shape (``Config.frame_tile``
        wide; mean and max)."""
        fn = self.renderer.make_stats_fn(self._statics())
        if fn is None:
            print("walk stats need the fused frame kernel (wide tables, packet_fused)", file=file)
            return None
        s = fn(self.frame_params()).cpu().numpy()
        statics = self._statics()
        phases = stats_phases(statics.bounce_count, statics.cast_shadows, statics.enable_diffuse)
        print(f"tiles={s.shape[0]} rays_cast={s[:, 0].sum()}", file=file)
        for p, name in enumerate(phases):
            st, lf, tr = s[:, 1 + 3 * p], s[:, 2 + 3 * p], s[:, 3 + 3 * p]
            print(
                f"{name}: pops/tile {st.mean():8.1f} (max {st.max():6d})"
                f"  leafs/tile {lf.mean():7.1f} (max {lf.max():6d})"
                f"  tris/tile {tr.mean():8.1f} (max {tr.max():6d})",
                file=file,
            )
        return s

    def tune(self, samples: int = 32, file=sys.stdout) -> dict | None:
        """Autotune the frame kernel's launch shape (``frame_tile``,
        ``frame_warp``) for this scene and view on the renderer's device
        (utils/autotune.py) and apply the winner to the session config;
        results persist next to the scene cache (``scene_key``).  Needs
        the fused route (wide tables, ``packet_fused``, ``which`` not 3),
        where the knobs act."""
        from shader_ray_tpu_torch.ops.engine_frame import fused_route

        if not fused_route(self.renderer.packed, self._statics(), self.renderer.cfg):
            print("autotune needs the fused frame kernel (wide tables, packet_fused, which != 3)",
                  file=file)
            return None
        from shader_ray_tpu_torch.utils.autotune import autotune

        best, results = autotune(
            self.renderer, self._statics(), self.frame_params(),
            samples=samples, key=getattr(self, "scene_key", None),
        )
        for tag, ms in sorted(results.items(), key=lambda kv: kv[1]):
            print(f"{ms:9.2f} ms/frame  {tag}", file=file)
        print(f"applied: {best}", file=file)
        self._fn_cache.clear()
        return best

    def set_knob(self, name: str, value: str, file=sys.stdout) -> bool:
        """Set a Config knob of the running App by field name (REPL
        ``set NAME VALUE``), coercing the string to the field's type and
        checking it with ``Config.validate``.  Render knobs (min_contrib,
        env_aniso, bounce_count, ...) take effect on the next frame, the
        frame functions being dropped; pack-time knobs only warn."""
        fields = {f.name for f in dataclasses.fields(type(self.cfg))}
        if name not in fields:
            print(f"unknown knob {name!r}; knobs: {', '.join(sorted(fields))}", file=file)
            return False
        cur = getattr(self.cfg, name)
        typ = bool if isinstance(cur, bool) else type(cur)
        try:
            if typ is bool:
                low = value.lower()
                if low in ("1", "true", "on", "yes"):
                    val = True
                elif low in ("0", "false", "off", "no"):
                    val = False
                else:
                    raise ValueError(value)
            else:
                val = typ(value)
        except ValueError:
            print(f"cannot parse {value!r} as {typ.__name__}", file=file)
            return False
        setattr(self.cfg, name, val)
        try:
            self.cfg.validate()
        except ValueError as e:
            setattr(self.cfg, name, cur)
            print(str(e), file=file)
            return False
        val = getattr(self.cfg, name)
        rcfg = getattr(self.renderer, "cfg", None)
        if rcfg is not None and rcfg is not self.cfg:
            setattr(rcfg, name, val)
        self._fn_cache.clear()
        self.redraw = True
        note = ("  (pack-time knob: takes effect after a scene reload)"
                if name in self._PACK_TIME_KNOBS else "")
        print(f"{name} = {val}{note}", file=file)
        return True

    def screenshot(self, path: str = "color.ppm") -> str:
        """Write the current frame as binary PPM (P6), the reference's
        color.ppm contract."""
        if self._frame is None or self.redraw:
            self.render()
        write_ppm(path, self._frame)
        return path

    # --- benchmark (reference 'b', ray.cpp:1096-1131) ------------------

    def benchmark(self, frame_count: int = 100, file=sys.stdout) -> list[float]:
        """Render ``frame_count`` frames, each waited for on the device,
        and print the reference's 10-bucket duration histogram plus
        Mrays/s."""
        params = self.frame_params()
        fn = self._render_fn()
        fn(params)
        self._sync()
        durations = []
        for _ in range(frame_count):
            then = time.perf_counter()
            fn(params)
            self._sync()
            durations.append(time.perf_counter() - then)
        frame_min, frame_max = min(durations), max(durations)

        print(f"{frame_count} frames:", file=file)
        bucket_count = 10
        duration_range = frame_max - frame_min
        for i in range(bucket_count):
            bucket_start = frame_min + duration_range * i / bucket_count
            bucket_end = frame_min + duration_range * (i + 1) / bucket_count
            last = i == bucket_count - 1
            count = sum(
                1 for d in durations
                if bucket_start <= d and (d <= bucket_end if last else d < bucket_end)
            )
            fps = 1.0 / ((bucket_start + bucket_end) / 2.0)
            print(f"{bucket_start * 1000.0:.2f} to {bucket_end * 1000.0:.2f} ms, "
                  f"{fps:.2f} fps : {count}", file=file)
        rays = self.width * self.height * 6
        med = float(np.median(durations))
        print(f"median {med * 1e3:.2f} ms, {rays / med / 1e6:.1f} Mrays/s "
              f"(potential, W*H*6)", file=file)
        # rays actually cast, counted once outside the timed loop
        cast = self.renderer.make_count_fn(self._statics())(params)
        print(f"rays cast {cast} ({cast / med / 1e6:.1f} Mrays/s measured)", file=file)
        return durations

    # --- keyboard (reference KeyCallback, ray.cpp:791-856) -------------

    def key(self, k: str) -> None:
        if k == "[":
            self.fov /= 1.05
            print(f"fov = {self.fov:f}")
            self.redraw = True
        elif k == "]":
            self.fov *= 1.05
            print(f"fov = {self.fov:f}")
            self.redraw = True
        elif k == ",":
            self.which -= 1
            print(f"which = {self.which}")
            self.redraw = True
        elif k == ".":
            self.which += 1
            print(f"which = {self.which}")
            self.redraw = True
        elif k in ("q", "Q", "\033"):
            self.quit = True
        elif k in ("o", "O"):
            self.motion_target = MotionTarget.OBJECT
        elif k in ("l", "L"):
            self.motion_target = MotionTarget.LIGHT
        elif k in ("b", "B"):
            self.do_benchmark = True
            self.redraw = True
        elif k in ("s", "S"):
            self.screenshot("color.ppm")
        elif k in ("p", "P"):
            # a stub in the reference (ray.cpp:846-848), implemented there
            np.set_printoptions(precision=4, suppress=True)
            print(f"camera_matrix =\n{self.world.camera_matrix}")
            print(f"object_matrix =\n{self.world.object_matrix}")
            print(f"light_dir = {self.light_dir}")
        elif k in ("d", "D"):
            self.which_diffuse_color = (self.which_diffuse_color + 1) % len(DIFFUSE_COLORS)
            self.redraw = True
        elif k in ("m", "M"):
            self.which_material = (self.which_material + 1) % len(MATERIALS)
            self.redraw = True

    # --- mouse (reference Button/MotionCallback, ray.cpp:862-918) ------

    def button(self, pressed: bool, x: float, y: float, shift: bool = False) -> None:
        if pressed:
            self._button_pressed = True
            self._shift_pressed = shift
            self._ox, self._oy = x, y
            self.redraw = True
        else:
            self._button_pressed = False

    def motion(self, x: float, y: float) -> None:
        if not self._motion_reported:
            self._motion_reported = True
            self._ox, self._oy = x, y
        dx, dy = x - self._ox, y - self._oy
        self._ox, self._oy = x, y
        if not self._button_pressed:
            return
        if self._shift_pressed:
            # exponential zoom (ray.cpp:902)
            self.zoom *= float(np.exp(np.log(5.0) / self.height / 2.0 * -dy))
        elif self.motion_target is MotionTarget.OBJECT:
            # reverse of OpenGL (ray.cpp:905-906)
            self.object_rotation = cam.trackball_motion(
                self.object_rotation, -(dx / self.width), -(dy / self.height)
            )
        else:
            self.light_rotation = cam.trackball_motion(
                self.light_rotation, dx / self.width, dy / self.height
            )
        cam.update_view_params(self.world, self.zoom, self.object_rotation, self.object_position)
        self.light_dir = cam.update_light(self.light_rotation)
        self.redraw = True

    def drag(self, dx: float, dy: float, shift: bool = False) -> None:
        """A full press-move-release gesture in pixels."""
        set_frame(self.frames + 1)
        with span("app.drag"):
            x0, y0 = self.width / 2.0, self.height / 2.0
            self._motion_reported = True
            self.button(True, x0, y0, shift)
            self.motion(x0 + dx, y0 + dy)
            self.button(False, x0 + dx, y0 + dy)
