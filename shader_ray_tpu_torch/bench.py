"""Headline benchmark of the port: Mrays/s on the bunny-class scene, on
the card (counterpart of the repository's ``bench.py``).

    python -m shader_ray_tpu_torch.bench                  # on the card
    BENCH_DEVICE=cpu BENCH_WIDTH=32 BENCH_HEIGHT=24 BENCH_TRIS=2000 \\
        BENCH_BATCH=2 BENCH_FRAMES=1 python -m shader_ray_tpu_torch.bench

The workload is ``bench.py``'s: a 69k-triangle bunny-class mesh
(``fixtures.bunny_class_scene``) under ``procedural_sky(2048)``,
1024x768, 3 bounces and 3 hard-shadow rays a pixel, filmic tonemap,
``which=0``, through ``engine.Renderer`` (the fused frame kernel by
default).  Potential rays are W*H*6 a frame; the rays actually cast
(``make_count_fn``, outside the timed loops) stand beside them.

Each timed call ends in a scalar read-back (``.item()`` of the frame's or
the batch's sum on the device) and is timed by the host clock around it:
the time the user waits, launch and host work included, without the
frame's copy to the host.  In order: the first frame (``make_fn``, on a
cold build directory with the nvcc build; printed on stderr), the golden
gate on it, FRAMES single frames (``make_checksum_fn``), FRAMES batches of
BATCH samples (``make_progressive_fn(..., reduce_sum=True)``, one frame
kernel launch each; the median batch over BATCH is the headline's time a
sample), the rays cast, then the sub-metrics ``occluded`` (ridged terrain
under a grazing light), ``which1`` (the textureGrad env mode, ``env_aniso``
from the configuration) and ``large_340k`` (a LARGE_TRIS-triangle scene).

Settings, read from the environment as ``bench.py`` reads them:
BENCH_WIDTH, BENCH_HEIGHT, BENCH_FRAMES, BENCH_BATCH, BENCH_TRIS,
BENCH_SHADOWS, BENCH_BOUNCES, BENCH_WHICH, BENCH_OCCLUDED=0 and
BENCH_EXTRAS=0 (skip the sub-metrics), BENCH_GOLDEN=0 (skip the gate);
the ``SRT_*`` knobs through ``Config.from_env``.  BENCH_DEVICE names the
torch device, the card by default; ``cpu`` runs the kernels' plain
versions, and its numbers are the CPU's (``device.name`` is ``"cpu"``).
BENCH_TUNE picks the frame kernel's launch shape before each scene is
timed (``_maybe_tune``, utils/autotune.py): ``auto`` (the default)
applies a tune persisted for the scene and its statics, and never
searches; ``1`` searches (persisted, so a rerun is a cache hit); ``0``
keeps the shipped defaults.  The golden gate runs under the knobs applied.

The last line of stdout is one JSON object: ``metric`` "mrays_per_s",
``value`` (potential Mrays/s of the headline), ``unit``,
``rays_potential``, ``frame_ms`` (the headline's time a sample),
``frame_ms_single_dispatch``, ``frames_per_dispatch``, ``rays_cast``,
``mrays_per_s_cast``, the nested ``occluded``, ``which1`` and
``large_340k``, and ``device`` (``name``, ``count``, ``power_limit_w``
from nvidia-smi).  ``bench.py``'s ``vs_baseline`` (a TPU target) is left
out, and milliseconds keep 3 decimals.

Exit codes: 0; 2 without the asked-for device; 3 when
the golden gate fails (the line then carries ``value`` 0.0 and ``error``);
4 when a measurement after the headline raised: its key holds
``{"error": ...}`` and the line is still printed.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
import traceback
from typing import NoReturn

import numpy as np
import torch

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky, terrain_scene
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.ops import _build
from shader_ray_tpu_torch.ops.engine_frame import fused_route
from shader_ray_tpu_torch.ops.render import FrameParams, RenderStatics, default_frame_params
from shader_ray_tpu_torch.utils import mat4
from shader_ray_tpu_torch.utils.cache import cached_scene_data

WIDTH = int(os.environ.get("BENCH_WIDTH", "1024"))
HEIGHT = int(os.environ.get("BENCH_HEIGHT", "768"))
FRAMES = int(os.environ.get("BENCH_FRAMES", "5"))
# samples a progressive batch, one frame-kernel launch (the REPL's `prog N`);
# BENCH_BATCH=1 times bare single frames
BATCH = int(os.environ.get("BENCH_BATCH", "1024"))
LARGE_TRIS = 340000  # triangles of the large_340k sub-metric's scene
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "tests", "golden", "bench_which0.npy")


def _scene_key(name: str, tris: int, cfg: Config) -> str:
    """``bench.py``'s cache key of a fixture scene, letter for letter."""
    return (
        f"bench-{name}-{tris // 1000}k"
        f"-l{cfg.bvh_leaf_max}-d{cfg.bvh_max_depth}"
        + (f"-{cfg.splits}" if cfg.splits != "object" else "")
        + (f"-opt{cfg.bvh_opt}" if cfg.bvh_opt else "")
    )


def _fixture_scene(name: str, scene, tris: int):
    """(SceneData, key) of fixture ``scene(tris)``, built under
    ``Config.from_env`` through the scene cache."""
    cfg = Config.from_env()

    def build():
        pos, _ = scene(tris)
        return get_shader_data(make_world(TriangleSet.from_arrays(pos), cfg), cfg)

    key = _scene_key(name, tris, cfg)
    return cached_scene_data(key, build, verbose=True), key


def build_scene_data(tris: int | None = None):
    """(SceneData, sky, cache key) of the bunny-class scene of ``tris``
    triangles (BENCH_TRIS, default 69000)."""
    if tris is None:
        tris = int(os.environ.get("BENCH_TRIS", "69000"))
    data, key = _fixture_scene("bunny-class", bunny_class_scene, tris)
    return data, procedural_sky(2048), key


def _emit_error(message: str, code: int) -> NoReturn:
    """The error JSON line (``value`` 0.0: no measurement) and exit ``code``."""
    print(message, file=sys.stderr)
    print(json.dumps({"metric": "mrays_per_s", "value": 0.0, "unit": "Mrays/s",
                      "error": message}))
    sys.exit(code)


def _device() -> torch.device:
    """BENCH_DEVICE, the card by default; without a card, exit 2."""
    device = torch.device(os.environ.get("BENCH_DEVICE", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        _emit_error("no CUDA device: the bench measures the card; set BENCH_DEVICE=cpu to run "
                    "the plain PyTorch versions on the CPU (CPU numbers, not the card's)", 2)
    return device


def _device_info(device: torch.device) -> dict:
    """Name, device count and power limit (watts, from nvidia-smi) of the
    device the numbers come from."""
    if device.type != "cuda":
        return {"name": "cpu", "count": 1, "power_limit_w": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    info = {"name": torch.cuda.get_device_name(index), "count": torch.cuda.device_count()}
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        print(f"nvidia-smi: {lines[index]}", file=sys.stderr)
        info["power_limit_w"] = float(lines[index].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError) as e:
        info["power_limit_w"] = {"error": f"nvidia-smi power.limit unread: {e}"}
    return info


def _frame_params(extent: float, fov: float, diffuse, specular: float,
                  light=None) -> FrameParams:
    """The bench camera: zoom = extent/2/sin(fov/2) down -z (ray.cpp:1079)."""
    zoom = extent / 2.0 / np.sin(fov / 2.0)
    params = default_frame_params(fov=fov)._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0.0, 0.0, zoom).astype(np.float32)),
        diffuse_color=torch.tensor(diffuse, dtype=torch.float32),
        specular_color=torch.full((3,), specular, dtype=torch.float32),
    )
    if light is not None:
        params = params._replace(light_dir=torch.from_numpy(light))
    return params


def _host_times(call, n: int) -> list[float]:
    """Host seconds of each of ``n`` calls; each call ends in its fence."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return times


def _sample_time(renderer, statics, params, batch: int, frames: int) -> float:
    """Seconds a sample: the median of ``frames`` progressive batches of
    ``batch`` samples (one launch each on the fused route), after a warm-up
    batch, over ``batch``."""
    pfn = renderer.make_progressive_fn(statics, batch, reduce_sum=True)
    pfn(params).item()
    return float(np.median(_host_times(lambda: pfn(params).item(), frames))) / batch


def _failed(key: str, e: Exception) -> dict:
    """A measurement that raised: its traceback on stderr, its error entry."""
    traceback.print_exc()
    print(f"{key} failed: {e}", file=sys.stderr)
    return {"error": f"{type(e).__name__}: {e}"}


def has_error(out) -> bool:
    """Whether a measurement in ``out`` (nested dicts) holds an error."""
    return isinstance(out, dict) and ("error" in out or any(has_error(v) for v in out.values()))


def _maybe_tune(renderer, statics, params, scene_key) -> None:
    """The launch-shape autotune before a measurement (bench.py:585-625).
    BENCH_TUNE modes: "1" runs the search on the device (persisted next
    to the scene cache; a rerun is a cache hit); "auto" (the default)
    applies a persisted tune if there is one and never searches; "0"
    keeps the shipped defaults.  Each sub-benchmark starts from its
    renderer's pre-tune config, so one scene's winner does not leak into
    another's measurement."""
    mode = os.environ.get("BENCH_TUNE", "auto")
    if mode == "0" or BATCH <= 1:
        return
    from shader_ray_tpu_torch.utils.autotune import autotune, load_tuned

    if not hasattr(renderer, "_pretune_cfg"):
        renderer._pretune_cfg = copy.copy(renderer.cfg)
    renderer.cfg = copy.copy(renderer._pretune_cfg)
    samples = min(BATCH, 1024)
    if mode != "1":
        best = load_tuned(scene_key, statics, samples, device=renderer.device)
        if best:
            print(f"applying cached tune: {best}", file=sys.stderr)
            for k, v in best.items():
                setattr(renderer.cfg, k, v)
        return
    autotune(renderer, statics, params, samples=samples, frames=2, key=scene_key)


def main() -> None:
    device = _device()
    info = _device_info(device)
    power = info["power_limit_w"]
    where = f"{info['name']}, " + (f"{power:.2f} W" if isinstance(power, float) else "power limit unknown")
    print(f"device: {device} ({where}), count {info['count']}", file=sys.stderr)
    cfg = Config.from_env()

    data, env, scene_key = build_scene_data()
    print(f"scene: {data.triangle_count} tris, {data.group_count} bvh nodes", file=sys.stderr)
    renderer = Renderer(data, env, cfg, device=device)

    # from_config, so env_aniso (4) reaches which=1 (bench.py:309-312)
    statics = RenderStatics.from_config(
        cfg,
        width=WIDTH,
        height=HEIGHT,
        cast_shadows=os.environ.get("BENCH_SHADOWS", "1") != "0",
        bounce_count=int(os.environ.get("BENCH_BOUNCES", "3")),
        which=int(os.environ.get("BENCH_WHICH", "0")),
    )
    route = fused_route(renderer.packed, statics, renderer.fused)
    print(f"route: {'fused frame kernel' if route else 'unfused'}, {cfg.packet_kernel} tables",
          file=sys.stderr)
    fov = np.deg2rad(40.0)
    # the bunny-class sphere has extent ~2.6
    params = _frame_params(2.6, fov, (0.8, 0.2, 0.2), 0.05)
    _maybe_tune(renderer, statics, params, scene_key)

    fn = renderer.make_fn(statics)
    fsum = renderer.make_checksum_fn(statics)
    t0 = time.perf_counter()
    img = fn(params).cpu().numpy()  # the kernels' build + first frame + full fetch
    print(f"compile+first frame: {time.perf_counter() - t0:.2f}s", file=sys.stderr)
    _golden_gate(img)
    if not np.isfinite(img).all():
        raise RuntimeError("non-finite pixels in the benchmark frame")

    fsum(params).item()
    times = _host_times(lambda: fsum(params).item(), FRAMES)
    t_single = float(np.median(times))
    t = _sample_time(renderer, statics, params, BATCH, FRAMES) if BATCH > 1 else t_single
    rays = WIDTH * HEIGHT * 6  # 3 bounce + 3 shadow rays a pixel
    mrays = rays / t / 1e6
    print(
        f"frame: {t * 1e3:.3f} ms amortized over batch={BATCH} "
        f"({t_single * 1e3:.3f} ms single-dispatch, min {min(times) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f}) on {where}",
        file=sys.stderr,
    )
    out = {
        "metric": "mrays_per_s",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "rays_potential": rays,
        "frame_ms": round(t * 1e3, 3),
        "frame_ms_single_dispatch": round(t_single * 1e3, 3),
        "frames_per_dispatch": BATCH,
    }
    try:
        cast = renderer.make_count_fn(statics)(params)
        out["rays_cast"] = cast
        out["mrays_per_s_cast"] = round(cast / t / 1e6, 2)
    except Exception as e:  # reported in the line, and the run exits 4
        out["rays_cast"] = out["mrays_per_s_cast"] = _failed("rays_cast", e)

    subs = {}
    if os.environ.get("BENCH_OCCLUDED", "1") != "0":
        subs["occluded"] = lambda: bench_occluded(statics, fov, device=device)
    if os.environ.get("BENCH_EXTRAS", "1") != "0":
        def which1():
            # its own tune: the statics differ by which, and so may the winner
            s1 = statics._replace(which=1)
            _maybe_tune(renderer, s1, params, scene_key)
            return _time_progressive(renderer, s1, params)

        def large():
            t0 = time.perf_counter()
            data_l, env_l, key_l = build_scene_data(LARGE_TRIS)
            print(f"large scene: {data_l.triangle_count} tris, {data_l.group_count} bvh nodes, "
                  f"built or loaded in {time.perf_counter() - t0:.2f}s", file=sys.stderr)
            r_l = Renderer(data_l, env_l, cfg, device=device)
            _maybe_tune(r_l, statics, params, key_l)
            return _time_progressive(r_l, statics, params)

        subs["which1"] = which1

        subs["large_340k"] = large
    for key, measure in subs.items():
        try:
            out[key] = measure()
        except Exception as e:  # reported in the line, and the run exits 4
            out[key] = _failed(key, e)
    out["device"] = info
    print(f"launches: {json.dumps(dict(_build.LAUNCHES))}", file=sys.stderr)
    print(json.dumps(out))
    if has_error(out):
        sys.exit(4)


def _golden_gate(img: np.ndarray) -> None:
    """The correctness gate before anything is timed (bench.py:513-567):
    the first frame, box-downsampled 4x, against tests/golden/
    bench_which0.npy on 0-1-scale tolerances: mean err <= 0.005 and <= 1%
    of pixels off by > 0.02.  Only at the canonical configuration the
    golden was rendered at; BENCH_GOLDEN=0 skips it.  An unreadable golden
    fails the gate (``bench.py`` skips it): no caught failure may let the
    run exit 0."""
    if os.environ.get("BENCH_GOLDEN", "1") == "0":
        print("golden gate: skipped (BENCH_GOLDEN=0)", file=sys.stderr)
        return
    canonical = (
        WIDTH == 1024 and HEIGHT == 768
        and int(os.environ.get("BENCH_TRIS", "69000")) == 69000
        and int(os.environ.get("BENCH_WHICH", "0")) == 0
        and os.environ.get("BENCH_SHADOWS", "1") != "0"
        and int(os.environ.get("BENCH_BOUNCES", "3")) == 3
    )
    if not canonical:
        print("golden gate: skipped (non-canonical bench config)", file=sys.stderr)
        return
    try:
        ref = np.load(GOLDEN)
    except (OSError, ValueError) as e:
        _emit_golden_fail(f"golden unreadable: {e}")
    down = 4
    got = (
        img.astype(np.float32)
        .reshape(HEIGHT // down, down, WIDTH // down, down, 3)
        .mean(axis=(1, 3))
    )
    if got.shape != ref.shape:
        _emit_golden_fail(f"shape {got.shape} vs golden {ref.shape}")
    err = np.abs(got - ref)
    mean_err = float(err.mean())
    off_share = float((err.max(axis=-1) > 0.02).mean())
    line = f"mean err {mean_err:.5f}, off pixels (>0.02) {off_share:.4%}"
    if mean_err > 0.005 or off_share > 0.01:
        _emit_golden_fail(line)
    print(f"golden gate: ok ({line})", file=sys.stderr)


def _emit_golden_fail(detail: str) -> NoReturn:
    """The gate's failure: its error JSON line (``value`` 0.0: no
    measurement, not zero speed) and exit 3."""
    print(f"golden gate: FAILED ({detail})", file=sys.stderr)
    _emit_error(f"GOLDEN GATE FAILED: rendered frame does not match the committed golden "
                f"({detail}) — refusing to time a wrong frame", 3)


def _time_progressive(renderer, statics, params, batch=None, frames=3) -> dict:
    """The median time a sample of a progressive batch (the headline's
    method), as a nested metric."""
    batch = batch or BATCH
    t = _sample_time(renderer, statics, params, batch, frames)
    rays = statics.width * statics.height * 6
    return {
        "value": round(rays / t / 1e6, 2),
        "unit": "Mrays/s",
        "frame_ms": round(t * 1e3, 3),
        "frames_per_dispatch": batch,
    }


def bench_occluded(statics, fov, *, device: torch.device | None = None) -> dict:
    """The occlusion-heavy scene (bench.py:653-727): ``terrain_scene``
    (BENCH_TRIS triangles) under a grazing light, so shadow rays hit real
    occluders, timed as the headline; ``device`` defaults to BENCH_DEVICE."""
    tris = int(os.environ.get("BENCH_TRIS", "69000"))
    data, key = _fixture_scene("terrain", terrain_scene, tris)
    renderer = Renderer(data, procedural_sky(2048), Config.from_env(), device=device or _device())
    light = np.array([0.78, 0.5, 0.37], np.float32)
    light /= np.linalg.norm(light)
    params = _frame_params(2.9, fov, (0.7, 0.6, 0.45), 0.04, light)
    _maybe_tune(renderer, statics, params, key)
    fsum = renderer.make_checksum_fn(statics)
    fsum(params).item()
    if BATCH > 1:
        t = _sample_time(renderer, statics, params, BATCH, FRAMES)
    else:
        t = float(np.median(_host_times(lambda: fsum(params).item(), FRAMES)))
    rays = WIDTH * HEIGHT * 6
    out = {
        "metric": "mrays_per_s_occluded",
        "value": round(rays / t / 1e6, 2),
        "unit": "Mrays/s",
        "frame_ms": round(t * 1e3, 3),
        "frames_per_dispatch": BATCH,
    }
    try:
        cast = renderer.make_count_fn(statics)(params)
        out["rays_cast"] = cast
        out["mrays_per_s_cast"] = round(cast / t / 1e6, 2)
    except Exception as e:  # reported in the line, and the run exits 4
        out["rays_cast"] = out["mrays_per_s_cast"] = _failed("occluded rays_cast", e)
    return out


if __name__ == "__main__":
    main()
