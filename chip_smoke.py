#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (shader_ray_tpu_torch).

Builds the bench scene (bunny-class 69k triangles, procedural_sky(2048),
1024x768, 3 bounces, shadows on) from a seed-free procedural fixture,
builds the four CUDA kernels with nvcc (all started together), holds each
kernel against its plain PyTorch version on the card, and drives the
port's two paths through the Renderer's entry points:

* the fused path (``frame_kernel``): make_fn, make_progressive_fn,
  make_count_fn at which=0, gated on tests/golden/bench_which0.npy;
  make_fn at which=1 (env_aniso=4) and which=2, one launch a frame, held
  to the unfused route's frames, and which=1's progressive and count;
  make_stats_fn, its per-tile rows summed against the frame's counter
  row and the count; make_fn at which=5, one launch of the kernel's
  given-rays form over the 25 sub-ray sets, gated on
  tests/golden/bench_which5_oracle.npy and held to the unfused frame; a
  frame and a count at Config.min_contrib = 0.004 (lane retirement);
* the unfused path (``trace_wide``, ``trace_binary``, ``env_sample``):
  ``Config(packet_fused=False)`` and ``Config(packet_kernel="binary")``
  at which=0 (held to the fused frame and the same golden), which=5
  (gated on tests/golden/bench_which5_oracle.npy), which=1/2/3;
* the app: the REPL (``app/main.repl``) over an ``App`` on the bench
  scene at 1024x768 (APP_SCRIPT, its ``b`` histogram's median and p95),
  and the CLI ``python -m shader_ray_tpu_torch`` once as a subprocess;
* the other builds: the bench scene with ``Config(splits="sbvh")``
  (duplicated, clipped triangle references) through the fused frame and
  the unfused frame on wide and on binary tables, and with
  ``Config(bvh_opt="reinsert")`` through the fused frame, each gated on
  tests/golden/bench_which0.npy, the kernels held to their plain versions
  on those tables and the frame kernel timed beside the object split's;
* image backgrounds: PNG (the port's encoder), BMP and TGA written here
  and the committed baseline JPEG through ``load_background``, and an App
  frame over the JPEG env equal to the frame over its pixels as .npy;
* the browser viewer (``app/webview.WebViewer``) over an App on the bench
  scene, driven by a client thread over HTTP on 127.0.0.1, with the
  render and PNG-encode times of a served frame;
* the CLI twice with one SRT_CACHE_DIR: the second run hits the scene
  cache and writes the same frame;
* the Moller-Trumbore leaf form (``Config(leaf_isect="mt")``, phase
  ``isect``): fused which 0, 1, 2 and 5, the count and stats fns
  and the unfused frame through the Renderer, gated on the bench goldens
  and held to the Woop frames; its kernels (``frame_kernel_mt``,
  ``trace_wide_mt``: the mt instantiations) held to their plain versions
  as the Woop form's are, and the trace to the brute-force oracle
  ``ops/reference.intersect_brute`` on 4096 seeded primaries
  (``oracle_disagreement``); each instantiation's registers, spills and
  blocks an SM; the mt and Woop kernels timed in turns, with the mt
  form's bound.
* the port's bench (phase ``bench``): ``python -m
  shader_ray_tpu_torch.bench`` at its defaults (bench69k, K = 1024, the
  occluded, which1 and large_340k sub-metrics) under BENCH_TUNE=0 as a
  subprocess, its JSON line printed and held to its fields, its golden
  gate, this run's cast count and its own launch counts; the K = 1024
  linear mean held to 16 launches over its 64-jitter slices
  (``bench_phase``);
* the frame kernel's launch shapes and the autotune (phase ``tune``,
  last, under a temporary SRT_CACHE_DIR): each of FRAME_SHAPES (tile
  widths 8, 16, 32, 64, warp maps rows and bricks) bit for bit the
  default launch in which = 0, which = 1 aniso 4 and the given-rays form,
  its per-tile rows held to frame_plain's on a 256 x 192 frame, a refused
  width raising and failing as a search candidate; each shape timed at
  K = 1 and K = 64 with its registers; App.tune(64) on the bench scene
  and its cache hit with no launch; the bench under BENCH_TUNE=1, then
  auto, through its golden gate (``tune_phase``).

The frame kernel is also held to its plain version in each of its env
modes and on the control-flow cases of its wave compaction (FRAME_CASES,
a ray exactly along +y among them: NaN in the grad modes exactly where
the plain version has it; given rays; min_contrib 0.004, 0.2 and 1.0,
the last also equal to the kernel's own one-bounce frame), the two trace kernels on the
edges of their active masks and ray layouts (TRACE_CASES), the env sampler
on directions exactly along +-y (NaN in grad mode exactly where the plain
version has it, env_disagreement), and the kernels' launch resources
(registers, shared memory, blocks an SM; the frame kernel's for each env
mode and form) are printed.  Each path runs
with the launch counts set to 0 just before it and read just after.
Then it times every kernel with CUDA events at the main path's shapes
beside its bound and its plain version (the trace kernels also beside
the bytes their loads move through the caches, counted from the plain
walks' work), the frame kernel also beside
the same frame's six walks as separate trace_wide launches, in its
grad modes beside the unfused which=1 frame, in its given-rays form (the
which=5 frame) beside the unfused which=5 frame, and at min_contrib =
0.004.  The other builds, the image backgrounds, the viewer and the CLI's
scene cache run after those timings.  It prints one JSON line with the
kernel table plus a final status line.

    python3 chip_smoke.py        # from the repo root, on a machine with one NVIDIA GPU

Exits non-zero (and prints no result) without a CUDA device or outside
a checkout of the repository.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1024, 768
SMALL = (256, 192)
PROG_K = 16
BATCH_K = 64
TIMED = 100  # timed calls per series
GOLDEN = os.path.join(ROOT, "tests", "golden", "bench_which0.npy")
GOLDEN5 = os.path.join(ROOT, "tests", "golden", "bench_which5_oracle.npy")
KERNEL_SOURCES = ("frame_kernel", "trace_kernel", "trace_binary_kernel", "env_kernel")
GRAD_MODES = ((1, 4), (2, 1))  # (which, env_aniso) of the fused grad-mode frames

# bound model (ops a sequential walk with early exits executes on this
# run's rays, f32, FMA = 2; counted by the plain versions).  A slab test
# of one box is ~26 ops and only non-empty children are tested; a binary
# step adds ~2 for its link select.  A Woop triangle test is ~17 ops up
# to its distance test, ~14 more up to u >= 0, ~16 more to the end (47 in
# full); a Moller-Trumbore test ~46, ~7, ~9 (62 in full).  An env lookup
# is ~40 ops of (u, v) math, ~40 more of derivatives and lod in grad mode,
# and ~30 per bilinear fetch.  Bytes: rays in, results out, tables once,
# and of the env only the texels these rays read.
OPS_PER_SLAB = 26
OPS_WOOP = (17, 14, 16)
OPS_PER_LINK = 2
OPS_MT = (46, 7, 9)
OPS_ENV_COORDS = 40
OPS_ENV_GRAD = 40
OPS_PER_FETCH = 30
PEAK_F32 = 67e12      # H100 SXM f32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_times(fn, n: int) -> list[float]:
    """Device ms of each of ``n`` calls (CUDA events around each), after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop in events]


def host_times(fn, n: int) -> list[float]:
    """Host-clock ms of each of ``n`` calls, each ended by a device
    synchronize (a frame as an interactive caller waits for it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def summary(ms: list[float]) -> str:
    """Median and p95 with n."""
    import numpy as np

    return (f"median {np.median(ms):.3f} ms, p95 {np.percentile(ms, 95):.3f} ms, "
            f"n={len(ms)}")


def device_breakdown(fn, ours: tuple[str, ...], n: int) -> dict | None:
    """Device ms per call by kernel over ``n`` calls, from torch.profiler:
    each of ``ours`` by name, every other kernel (PyTorch's elementwise,
    index and copy kernels) under "other", with launch counts per call.
    None if the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shader_ray_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {name: [0.0, 0.0] for name in (*ours, "other")}
    for e in prof.key_averages():
        # a span (utils/profiling.span: a launch's range under the wrapper's
        # bare name, a layer's under a dotted one) shows on the device too:
        # not a kernel
        if e.device_type != DeviceType.CUDA or e.key in ours or \
                e.key.split(":")[0] in profiling.SPANS:
            continue
        name = next((o for o in ours if o in e.key), "other")
        out[name][0] += e.self_device_time_total / 1e3 / n
        out[name][1] += e.count / n
    if sum(ms for ms, _ in out.values()) == 0.0:
        return None
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def binary_bytes(packed, D) -> int:
    """Bytes of the binary tables that rays of directions D need: the
    node banks of the octants among them, the triangle and normal
    tables."""
    octants = ((D[:, 0] > 0).long() + 2 * (D[:, 1] > 0).long() + 4 * (D[:, 2] > 0).long()).unique()
    return octants.numel() * nbytes(packed.nodes[0]) + nbytes(packed.tris, packed.normals)


def walk_ops(walks, per_link: int, per_tri: tuple[int, int, int]) -> tuple[int, str]:
    """Operations of the plain walks' counted work (the bound model
    above) and the counts as text."""
    slabs, tris, tris_u, tris_v = (
        sum(int(getattr(w, f).sum()) for w in walks) for f in ("slabs", "tris", "tris_u", "tris_v"))
    ops = (slabs * (OPS_PER_SLAB + per_link)
           + tris * per_tri[0] + tris_u * per_tri[1] + tris_v * per_tri[2])
    return ops, (f"{slabs} slab tests, {tris} triangle tests ({tris_u} past the distance test, "
                 f"{tris_v} past u)")


def bound(ops: float, moved: int) -> tuple[float, str]:
    """(bound ms, "operations" or "bytes"): the larger of ops over the
    f32 peak and bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32, moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def golden_gate(img, path: str, what: str) -> None:
    """bench._golden_gate's check: the 4x box-downsampled frame against
    the committed golden, mean err <= 0.005 and <= 1% of pixels off by
    more than 0.02."""
    import numpy as np

    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{what}: frame shape {img.shape} or non-finite pixels")
    ref = np.load(path)
    got = img.reshape(H // 4, 4, W // 4, 4, 3).mean(axis=(1, 3))
    err = np.abs(got - ref)
    mean_err = float(err.mean())
    off_share = float((err.max(axis=-1) > 0.02).mean())
    print(f"golden gate, {what} vs {os.path.basename(path)}: mean err {mean_err:.6f} "
          f"(limit 0.005), off pixels (>0.02) {off_share:.4%} (limit 1%)")
    if mean_err > 0.005 or off_share > 0.01:
        raise AssertionError(f"golden gate failed: {what} against {path}")

# cases of the frame kernel's control flow (wave compaction, ragged
# tiles, early exits), of its env modes (which = 1 with aniso 1 and 4,
# which = 2; a ray exactly along +y in both, NaN in the plain version), of
# its given-rays form (its own raygen's rays handed in, K = 2; the 25
# which = 5 sub-ray sets; a grad-mode ray exactly along +y) and of lane
# retirement (min_contrib 0.004, 0.2 and 1.0), held to frame_plain here
# and in tests/test_torch_isolation.py
FRAME_CASES = ("all-miss", "all-hit", "bad", "bounces0", "bounces1-noshadow",
               "nodiffuse", "k3-ragged", "which1", "which1-aniso4", "which2",
               "which1-aniso4-pole", "which2-pole", "given-raygen", "given-which5",
               "given-which1-aniso4-pole", "min-contrib-0.004", "min-contrib-0.2",
               "min-contrib-1")
CASE_SAMPLES = {"k3-ragged": 3, "given-raygen": 2, "given-which5": 25}  # K, where not 1


@functools.cache
def _case_tables(inside: bool, isect: str = "woop"):
    """The cases' packed tables on the CPU, with leaf test rows of form
    ``isect``: a closed sphere, or a 5000-triangle bunny-class scene."""
    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky, uv_sphere
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide

    pos, nrm = uv_sphere(lat=12, lon=16) if inside else bunny_class_scene(5000)
    return pack_scene_wide(get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm))),
                           procedural_sky(256), Config(leaf_isect=isect))


def frame_case(name: str, device, isect: str = "woop"):
    """(packed tables, uniforms, jitters, FrameSettings, given rays) of
    one case on ``device``, the tables' leaf test rows of form ``isect``:
    a 5000-triangle bench-like scene (the inside
    of a closed sphere for "all-hit").  A pole case looks up +y from
    beside the scene at a 64 x 64 frame with the jitter (0.5, 0.5): the
    centre pixel's ray is exactly (0, 1, 0).  A given-rays case hands its
    rays to the kernel (``GivenRays``, jitters None): the kernel's own
    raygen rays of its settings, or the which = 5 sub-ray sets of the
    primaries.  A min-contrib case renders a specular 0.05 (bench-like)
    scene with that retirement threshold."""
    import dataclasses

    import numpy as np
    import torch

    from shader_ray_tpu_torch.ops.engine_frame import (
        halton_jitters,
        pack_uniforms,
        primary_rays,
        supersample_directions,
    )
    from shader_ray_tpu_torch.ops.frame_kernel import FrameSettings, GivenRays, raygen_rays
    from shader_ray_tpu_torch.ops.render import RenderStatics, default_frame_params
    from shader_ray_tpu_torch.utils import mat4

    inside = name == "all-hit"
    base = name.removeprefix("given-")
    packed = _case_tables(inside, isect)
    if name == "bad":
        packed = dataclasses.replace(packed, stack_depth=2)
    spec = 0.05 if name.startswith("min-contrib") else 0.3
    params = default_frame_params()._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0.0, 0.0, 0.0 if inside else 3.8)),
        light_dir=torch.tensor([0.36, 0.48, 0.8]),
        diffuse_color=torch.tensor([0.8, 0.2, 0.2]),
        specular_color=torch.tensor([spec, spec, spec]),
    )
    if name == "all-miss":  # the camera turned away from the scene
        params = params._replace(camera_normal_matrix=torch.from_numpy(
            mat4.make_rotation(np.pi, 0.0, 1.0, 0.0)))
    fs = FrameSettings(width=64, height=48)
    jit = torch.from_numpy(halton_jitters(CASE_SAMPLES.get(name, 1)))
    if base.startswith("which") and base != "which5":
        fs = fs._replace(which=int(base[5]), env_aniso=4 if "aniso4" in base else 1)
    if base.endswith("-pole"):
        # eye -z to world +y, exactly: the centre ray's direction is (0, 1, 0)
        up = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
        params = params._replace(camera_normal_matrix=torch.from_numpy(up))
        fs = fs._replace(height=64)
        jit = torch.tensor([[0.5, 0.5]])
    elif name == "bounces0":
        fs = fs._replace(bounce_count=0)
    elif name == "bounces1-noshadow":
        fs = fs._replace(bounce_count=1, cast_shadows=False)
    elif name == "nodiffuse":
        fs = fs._replace(enable_diffuse=False)
    elif name == "k3-ragged":
        fs = fs._replace(width=37, height=29)
    elif name.startswith("min-contrib"):
        fs = fs._replace(min_contrib=float(name.removeprefix("min-contrib-")))
    packed, uni, jit = packed.to(device), pack_uniforms(params).to(device), jit.to(device)
    if not name.startswith("given-"):
        return packed, uni, jit, fs, None
    if base == "which5":
        on = type(params)(*[x.to(device) for x in params])
        rays, (right, up) = primary_rays(RenderStatics(width=fs.width, height=fs.height), on)
        given = GivenRays(rays.P.contiguous(), supersample_directions(rays.D, right, up))
    else:
        given = raygen_rays(uni, jit, fs)
    return packed, uni, None, fs, given


def _retired_unmet(name: str, fs, colour, counters, isect: str = "woop") -> bool:
    """Whether a min-contrib case's plain frame fails to show lane
    retirement.  At 1.0 every hit lane retires after bounce 0 (no later
    walk); below, fewer rays are cast than in the same frame at
    min_contrib 0, and the colour stays within 3 x min_contrib of it (the
    reference's bound, tests/test_fused.py)."""
    import torch

    from shader_ray_tpu_torch.ops import frame_kernel as fk

    later = 1 + 3 * (2 if fs.cast_shadows and fs.enable_diffuse else 1)  # after bounce 0's walks
    if fs.min_contrib >= 1.0:
        return int(counters[0]) <= fs.width * fs.height or bool(counters[later:].any())
    packed, uni, jit, _, _ = frame_case(name, colour.device, isect)
    exact, exact_n = fk.frame_plain(packed, uni, jit, fs._replace(min_contrib=0.0))
    err = float((colour - exact).abs().max()) if colour.shape == exact.shape else float("inf")
    return not int(counters[0]) < int(exact_n[0]) or err > 3 * fs.min_contrib


def case_unmet(name: str, fs, colour, counters, isect: str = "woop") -> str | None:
    """What a case's plain frame (tables of leaf form ``isect``) fails to
    show of the path it is for, or None.  An env-mode case bounces some rays (their differentials
    are transferred) and is finite; a pole case is NaN at exactly one
    pixel, the centre one; a given-rays case bounces some of its K sets'
    rays; a min-contrib case retires lanes (_retired_unmet)."""
    import torch

    primaries = CASE_SAMPLES.get(name, 1) * fs.width * fs.height
    cast = int(counters[0])
    painted = int((colour == torch.tensor([1.0, 0.0, 0.0], device=colour.device)).all(-1).sum())
    nan = torch.isnan(colour).any(-1)
    if name.startswith(("which", "given-")):
        pole = name.endswith("-pole")
        centre = bool(nan[fs.height // 2 - 1, fs.width // 2 - 1]) if nan.shape[:2] == (
            fs.height, fs.width) else False
        unmet = (int(nan.sum()) != (1 if pole else 0) or (pole and not centre)
                 or (not pole and cast <= primaries))
        return f"case {name}: cast {cast}, {int(nan.sum())} NaN pixels" if unmet else None
    if name.startswith("min-contrib"):
        unmet = _retired_unmet(name, fs, colour, counters, isect)
        return f"case {name}: cast {cast}, counters {counters.tolist()}" if unmet else None
    unmet = {
        "all-miss": cast != primaries,
        "all-hit": cast < fs.bounce_count * primaries or painted != 0,
        "bad": painted == 0,
        "bounces0": cast != 0 or counters.numel() != 1,
        "bounces1-noshadow": cast != primaries or counters.numel() != 4,
        "nodiffuse": counters.numel() != 1 + 3 * fs.bounce_count,
        "k3-ragged": tuple(colour.shape) != (fs.height, fs.width, 3),
    }[name]
    return f"case {name}: cast {cast}, {painted} red pixels, counters {counters.tolist()}" \
        if unmet else None


WALK_COUNTERS = ("node pops", "leaf visits", "triangle tests")


def walk_counter_excess(kn, pn) -> tuple[float, int]:
    """The largest ratio of a walk counter's difference (kernel vs plain,
    counter rows [1:]) to its limit, and that counter's index.  Limit:
    1e-3 of the plain count, or 1e-4 of the frame's whole walk count if
    that is more (a ray that flips changes every later walk of its pixel,
    which on a small phase is more than 1e-3), at least 1."""
    import torch

    kw, pw = kn[1:].double(), pn[1:].double()
    if pw.numel() == 0:
        return 0.0, 0
    limit = torch.clamp(1e-3 * pw, min=max(1e-4 * float(pw.sum()), 1.0))
    ratio = (kw - pw).abs() / limit
    i = int(ratio.argmax())
    return float(ratio[i]), i + 1


def frame_disagreement(kc, kn, pc, pn) -> str | None:
    """Why the kernel's (colour, counters) disagree with the plain
    version's, or None.  nvcc contracts multiply-adds into FMAs and the
    plain version does not, so a grazing ray may flip: mean abs colour
    <= 1e-4, rays cast within 1e-4 (one ray on a small frame), each walk
    counter within its limit (walk_counter_excess), the same counter row
    length, and colour NaN exactly where the plain version's is (a
    grad-mode ray along +-y) and finite everywhere else."""
    import torch

    cast_k, cast_p = int(kn[0]), int(pn[0])
    if kc.shape != pc.shape or kn.shape != pn.shape:
        return f"shapes {tuple(kc.shape)} {tuple(kn.shape)} vs {tuple(pc.shape)} {tuple(pn.shape)}"
    nan = torch.isnan(pc)
    if not torch.equal(torch.isnan(kc), nan):
        return "NaN where the plain version has none, or none where it has"
    kc, pc = kc[~nan], pc[~nan]
    if not torch.isfinite(kc).all():
        return "non-finite colour"
    if float((kc - pc).abs().mean()) > 1e-4:
        return f"mean abs colour {float((kc - pc).abs().mean()):.3e} > 1e-4"
    if abs(cast_k - cast_p) > max(1e-4 * cast_p, 1):
        return f"cast {cast_k} vs {cast_p}"
    excess, i = walk_counter_excess(kn, pn)
    if excess > 1.0:
        return (f"walk phase {(i - 1) // 3} {WALK_COUNTERS[(i - 1) % 3]}: {int(kn[i])} vs "
                f"{int(pn[i])}, {excess:.2f}x its limit")
    return None


# cases of the trace kernels' active masks and ray layouts: none of a
# block's rays active, all, one a block, every other warp, a seeded 3%, a
# ray count that ends inside a block, and an image whose width and height
# are no whole number of tiles (the kernels walk an image's rays in 2D
# tiles); held to the plain versions here and in
# tests/test_torch_isolation.py
TRACE_CASES = ("none", "all", "one-a-block", "every-other-warp", "random-3pct", "ragged",
               "tiles-ragged")
TRACE_BLOCK = 128        # threads a block of both trace kernels
RAGGED_IMAGE = (31, 23)  # width, height of the tiles-ragged case


def trace_case(name: str, P, D):
    """(P, D, active, width) of one case on the rays (P, D), whose count
    is a multiple of TRACE_BLOCK and at least 31 x 23: a mask over the
    rays as a list (width 0), all of a ray count that ends inside a
    block, or all the rays of a 31 x 23 image."""
    import numpy as np
    import torch

    R = P.shape[0]
    r = torch.arange(R, device=P.device)
    if name in ("ragged", "tiles-ragged"):
        R, width = (R - TRACE_BLOCK // 2 - 13, 0) if name == "ragged" else (
            RAGGED_IMAGE[0] * RAGGED_IMAGE[1], RAGGED_IMAGE[0])
        return (P[:R].contiguous(), D[:R].contiguous(),
                torch.ones(R, dtype=torch.bool, device=P.device), width)
    if name == "random-3pct":
        active = torch.from_numpy(np.random.default_rng(5).uniform(size=R) < 0.03).to(P.device)
    else:
        active = {"none": r < 0, "all": r >= 0, "one-a-block": r % TRACE_BLOCK == 77,
                  "every-other-warp": (r // 32) % 2 == 0}[name]
    return P, D, active, 0


def trace_case_unmet(name: str, active, steps) -> str | None:
    """What a case's walk (its active mask and per-ray node steps) fails
    to show of the path it is for, or None.  Every active ray steps at
    least once (the root), no inactive ray steps."""
    import torch

    R, n = active.shape[0], int(active.sum())
    per = active.long()
    unmet = bool(((steps > 0) != active).any()) or {
        "none": n != 0,
        "all": n != R or R % TRACE_BLOCK != 0,
        "one-a-block": R % TRACE_BLOCK != 0 or bool((per.view(-1, TRACE_BLOCK).sum(1) != 1).any()),
        "every-other-warp": R % 64 != 0 or not torch.equal(
            per.view(-1, 2, 32).sum(2).cpu(), torch.tensor([[32, 0]]).expand(R // 64, 2)),
        "random-3pct": not 0.01 * R < n < 0.05 * R,
        "ragged": R % TRACE_BLOCK == 0 or n != R,
        "tiles-ragged": R != RAGGED_IMAGE[0] * RAGGED_IMAGE[1] or n != R,
    }[name]
    return f"case {name}: {n} of {R} rays active, {int((steps > 0).sum())} walked" if unmet else None


def trace_disagreement(got, want, active, any_hit: bool) -> tuple[dict, str | None]:
    """A trace kernel's PacketHit (with stats) against its plain
    version's on the same rays: the errors measured and why they are
    beyond their limits, or None.  nvcc contracts multiply-adds into
    FMAs, the plain version does not, so a grazing ray may take another
    triangle or none.  Limits: hit flags flip on <= 0.1% of rays; where
    both versions hit, t agrees to 1e-4 * max(1, t) and ids are equal or
    tied (|dt| < 1e-6 * max(1, t)) on all but 0.01% of rays, and the mean
    |dt| is <= 1e-5; bad flags are equal; the kernel's node step, leaf
    visit and triangle test totals are each within 1e-3 of the plain
    walk's; on closest hits with equal ids the interpolated normals
    (length ~1) agree to 1e-5 mean abs; an inactive ray returns a miss,
    no id, no normal, not bad and no work."""
    import torch

    FAR = 1.0e7
    hit, hit_w = got.t < FAR, want.t < FAR
    both = hit & hit_w
    dt = (got.t - want.t).abs()
    scale = want.t.abs().clamp_min(1.0)
    R = max(got.t.shape[0], 1)
    e = {
        "flips": float((hit != hit_w).sum()) / R,
        "t_max": float(dt[both].max()) if both.any() else 0.0,
        "t_mean": float(dt[both].mean()) if both.any() else 0.0,
        "t_off": float((both & (dt > 1e-4 * scale)).sum()) / R,
        "ids": float((both & (got.which != want.which) & (dt >= 1e-6 * scale)).sum()) / R,
        "bad_equal": bool(torch.equal(got.bad, want.bad)),
        "stats_rel": max(abs(a - b) / max(b, 1) for a, b in zip(
            got.stats.sum(0).tolist(), want.stats.sum(0).tolist())),
        "n_mean": 0.0, "n_max": 0.0,
    }
    if not any_hit:
        same = both & (got.which == want.which)
        if same.any():  # a convex scene's shadow rays hit next to nothing
            dn = (got.normal - want.normal)[same].abs()
            e["n_mean"], e["n_max"] = float(dn.mean()), float(dn.max())
    idle = ~active
    idle_ok = bool((got.t[idle] == FAR).all() and (got.which[idle] == -1).all()
                   and (got.normal[idle] == 0).all() and not got.bad[idle].any()
                   and (got.stats[idle] == 0).all())
    why = [k for k, bad in (
        ("t mean", e["t_mean"] > 1e-5), ("t off", e["t_off"] > 1e-4),
        ("hit flips", e["flips"] > 1e-3), ("ids", e["ids"] > 1e-4),
        ("bad flags", not e["bad_equal"]), ("walk counters", e["stats_rel"] > 1e-3),
        ("normals", e["n_mean"] > 1e-5), ("inactive rays", not idle_ok),
    ) if bad]
    return e, ", ".join(why) or None


def env_disagreement(got, want, nan_rays=None) -> tuple[dict, str | None]:
    """env_sample's radiance against its plain version's on the same
    rays: the errors measured and why they are beyond their limits, or
    None.  Both call the card's atan2f/acosf/log2f and differ by FMA
    contraction in the texel coordinates, on radiance that reaches ~50 at
    the sun: mean abs <= 1e-5 and max abs <= 1e-2 over the finite rays.
    ``nan_rays`` (bool, one a ray) are the rays whose radiance is NaN in
    all three channels (grad mode along the +-y axis): the plain version
    and the kernel are NaN exactly there and finite everywhere else."""
    import torch

    expect = torch.zeros(want.shape[0], dtype=torch.bool, device=want.device) \
        if nan_rays is None else nan_rays
    fin = ~expect
    diff = (got[fin] - want[fin]).abs()
    e = {
        "max": float(diff.max()) if diff.numel() else 0.0,
        "mean": float(diff.mean()) if diff.numel() else 0.0,
        "nan_rays": int(torch.isnan(got).any(-1).sum()),
    }
    nan_row = expect[:, None].expand_as(want)
    why = [k for k, bad in (
        ("plain NaN off the expected rays", not torch.equal(torch.isnan(want), nan_row)),
        ("NaN where the plain version has none, or none where it has", not torch.equal(
            torch.isnan(got), torch.isnan(want))),
        ("non-finite radiance", not bool(torch.isfinite(got[fin]).all())),
        ("max abs", e["max"] > 1e-2), ("mean abs", e["mean"] > 1e-5),
    ) if bad]
    return e, ", ".join(why) or None


ORACLE_RAYS = 4096  # seeded bench primaries the mt trace is held to the brute-force oracle on


def _barycentric(tri, P, D):
    """Moller-Trumbore's (d, u, v, |cos|) of triangles tri (..., 3, 3) for
    rays P, D (..., 3), broadcast, with no accept test: where each ray
    meets each triangle's plane, and the cosine between the ray and the
    triangle's normal."""
    import torch

    def cross(a, b):
        return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)

    v0, e0, e1 = tri[..., 0, :], tri[..., 1, :] - tri[..., 0, :], tri[..., 0, :] - tri[..., 2, :]
    M = cross(e1, D)
    det = (e0 * M).sum(-1)
    T = P - v0
    Q = cross(T, e0)
    n = cross(e0, e1)
    cos = (det / (n.norm(dim=-1) * D.norm(dim=-1))).abs()
    return -(e1 * Q).sum(-1) / det, (T * M).sum(-1) / det, (D * Q).sum(-1) / det, cos


def t_tolerance(scale, cos):
    """The t limit of the oracle gate: 1e-6 of ``scale``, the larger of t
    and the ray origin's distance from the triangle's v0 (the size of
    Moller-Trumbore's T = P - v0, whose rounding d inherits: t itself
    for a ray from afar, as the bench primaries, but far more than t for
    a hit next to the origin), widened by 0.1 / |cos| where a ray meets
    the triangle within ~6 degrees of grazing (|cos| < 0.1): there f32
    Moller-Trumbore's determinant keeps ~|cos| of its precision, and two
    f32 evaluations of one hit (nvcc's contracted FMAs, PyTorch's separate
    roundings) differ by ~1e-6 of t at |cos| 0.01-0.05 on the bench
    primaries."""
    import torch

    return 1e-6 * scale * torch.clamp(0.1 / cos, min=1.0)


def oracle_disagreement(got, want, tris, P, D) -> tuple[dict, str | None]:
    """A closest-hit trace's PacketHit against the brute-force oracle's
    (t, which, u, v) (ops/reference.intersect_brute) on the same rays,
    tris the (T, 3, 3) triangles in BVH order: the errors measured and why
    they are beyond their limits, or None.  Where both pick the same
    triangle, t is within t_tolerance of the oracle's.  The ids and the
    hit flags are equal except where the oracle's closest distance is
    tied: its hit point lies on another triangle too (to t_tolerance in
    distance and 1e-5 in barycentrics: a ray through an edge or a vertex
    that two triangles share, where rounding picks a side and a test that
    is not watertight may let the ray through both), or where a hit
    grazes its triangle's edge to 1e-5 in barycentrics and the other
    answer misses (nvcc's FMAs decide that accept test)."""
    import torch

    FAR = 1.0e7
    t_b, w_b, u_b, v_b = want
    hit_k, hit_b = got.t < FAR, t_b < FAR
    w_k = got.which.long()
    same = hit_k & hit_b & (w_k == w_b)
    tri_b = tris[w_b.clamp_min(0)]
    _, _, _, cos_b = _barycentric(tri_b, P, D)
    scale = torch.maximum(t_b.abs(), (P - tri_b[:, 0]).norm(dim=-1))
    over = ((got.t - t_b).abs() / t_tolerance(scale, cos_b))[same]
    rel = ((got.t - t_b).abs() / t_b.abs().clamp_min(1e-30))[same]
    slack_b = torch.minimum(torch.minimum(u_b, v_b), 1.0 - u_b - v_b)
    _, u_k, v_k, _ = _barycentric(tris[w_k.clamp_min(0)], P, D)
    slack_k = torch.minimum(torch.minimum(u_k, v_k), 1.0 - u_k - v_k)
    differ = (hit_k != hit_b) | (hit_k & hit_b & (w_k != w_b))
    tied = torch.zeros_like(differ)
    rows = torch.nonzero(differ & hit_b).squeeze(1)
    if rows.numel():
        # every triangle at these rays: another one holding the oracle's hit point
        d, u, v, cos = _barycentric(tris[None], P[rows, None], D[rows, None])
        slack = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        tb = t_b[rows, None]
        far = torch.maximum(tb.abs(), (P[rows, None] - tris[None, :, 0]).norm(dim=-1))
        other = torch.arange(tris.shape[0], device=P.device)[None] != w_b[rows, None]
        tied[rows] = (other & ((d - tb).abs() <= t_tolerance(far, cos)) &
                      (slack >= -1e-5)).any(1)
    grazing = (hit_b & ~hit_k & (slack_b.abs() <= 1e-5)) | \
        (hit_k & ~hit_b & (slack_k.abs() <= 1e-5))
    off = differ & ~tied & ~grazing
    e = {
        "rays": int(P.shape[0]), "hits": int(hit_b.sum()),
        "t_rel_max": float(rel.max()) if rel.numel() else 0.0,
        "t_over_limit_max": float(over.max()) if over.numel() else 0.0,
        "differ": int(differ.sum()), "ties": int((differ & tied).sum()),
        "grazing": int((differ & grazing & ~tied).sum()), "off": int(off.sum()),
    }
    why = [k for k, bad in (
        ("t beyond its limit", e["t_over_limit_max"] > 1.0),
        ("ids or hit flags off outside ties and edge grazes", e["off"] > 0),
        ("ties and grazes over 1e-3 of the rays", e["differ"] > 1e-3 * e["rays"]),
    ) if bad]
    return e, ", ".join(why) or None


def ptxas_resources(log: str) -> dict[str, tuple[int, int, int]]:
    """Registers, spill-store and spill-load bytes a thread of each
    entry function in nvcc's -Xptxas=-v report, by mangled name."""
    import re

    out, fn, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = int(m.group(1)), int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = (int(m.group(1)), *spills)
            fn, spills = None, (0, 0)
    return out


def instantiation(mangled: str) -> str | None:
    """The frame or wide-trace kernel instantiation a mangled name is:
    "frame_kernel[<mode>, <form>, <leaf test>]" or "trace_wide[<leaf
    test>]"; None for another function."""
    import re

    isects = ("woop", "mt")
    m = re.search(r"5frameILi(\d)ELb([01])ELi(\d)E", mangled)
    if m:
        mode = ("bilinear", "grad", "probes", "dy")[int(m.group(1))]
        form = "given rays" if m.group(2) == "1" else "raygen"
        return f"frame_kernel[{mode}, {form}, {isects[int(m.group(3))]}]"
    m = re.search(r"10trace_wideILi(\d)E", mangled)
    return f"trace_wide[{isects[int(m.group(1))]}]" if m else None


def pole_rays(n: int, device):
    """(D, dDdx, dDdy, on the axis) of ``n`` rays, every fourth exactly
    along +y or -y (x = z = 0), the rest seeded directions away from the
    poles, all with seeded non-zero differentials."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    D = rng.normal(size=(n, 3)).astype(np.float32)
    D[:, 1] *= 0.5
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    axis = np.arange(n) % 4 == 0
    D[axis] = 0.0
    D[axis, 1] = np.where(np.arange(n)[axis] % 8 == 0, 1.0, -1.0)
    g = rng.normal(size=(2, n, 3)).astype(np.float32) * 1e-3
    return (*(torch.from_numpy(x).to(device) for x in (D, g[0], g[1])),
            torch.from_numpy(axis).to(device))


# loads a trace issues, in bytes through L1/L2, per unit of the plain
# walks' counted work: (this tree's layout, the layout before it).  Wide:
# a pop's 16 float4s (before: the order word, 8 child lo float4s, the hi
# float4 of each non-empty child); a Woop test's rows 0-2 (before: row 0,
# row 1 past the distance test, row 2 past u); 48 B of normals a hit ray.
# Binary: a step's 32-byte record (before: box 24 B, count 4 B, link 4
# B, first triangle 4 B a leaf visit); a test's 48 B (before: 36 B); the
# normals, 48 B once a hit ray (before: 36 B at each accepted hit,
# counted once a hit ray here, so a lower bound).
def cache_bytes(tree: str, walk, hit_rays: int) -> tuple[int, int]:
    steps, slabs, leafs, tris, tris_u, tris_v = (
        int(getattr(walk, f).sum()) for f in ("steps", "slabs", "leafs", "tris", "tris_u", "tris_v"))
    if tree == "wide":
        return (steps * 256 + tris * 48 + hit_rays * 48,
                steps * (4 + 128) + slabs * 16 + (tris + tris_u + tris_v) * 16 + hit_rays * 48)
    return (steps * 32 + tris * 48 + hit_rays * 48,
            steps * 32 + leafs * 4 + tris * 36 + hit_rays * 36)


@functools.cache
def bench_world():
    """The World of the bench scene (bench.py:289-331): the 69k-triangle
    bunny-class scene with its BVH."""
    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.models.world import make_world

    return make_world(TriangleSet.from_arrays(*bunny_class_scene(69000)),
                      Config(use_native="require"))


def bench_inputs():
    """The bench configuration (bench.py:289-331): the 69k-triangle
    bunny-class scene, procedural_sky(2048) and the bench camera, as
    (SceneData, sky, FrameParams on the CPU)."""
    import numpy as np
    import torch

    from shader_ray_tpu_torch.models.fixtures import procedural_sky
    from shader_ray_tpu_torch.models.world import get_shader_data
    from shader_ray_tpu_torch.ops.render import default_frame_params
    from shader_ray_tpu_torch.utils import mat4

    data = get_shader_data(bench_world())
    fov = np.deg2rad(40.0)
    zoom = 2.6 / 2.0 / np.sin(fov / 2.0)
    params = default_frame_params(fov=fov)._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0.0, 0.0, zoom)),
        diffuse_color=torch.tensor([0.8, 0.2, 0.2]),
        specular_color=torch.tensor([0.05, 0.05, 0.05]),
    )
    return data, procedural_sky(2048), params


APP_SCRIPT = ("m", "d", "drag 30 10", "zoom -20", "[", *["."] * 5, *[","] * 5, "prog 4", "stats",
              "s", "b", "q")


def app_phase(renderer, card: str) -> list[float]:
    """Drive the App's REPL (APP_SCRIPT) on the bench scene at W x H
    through ``renderer`` in a temporary working directory, then the CLI
    once as a subprocess.  Every frame must be (H, W, 3) and finite, the
    which = 5 frame equal to ``make_fn``'s for the same params, and the
    launches only frame_kernel's.  Returns the ``b`` benchmark's
    durations in ms."""
    import io
    import tempfile

    import numpy as np
    import torch

    from shader_ray_tpu_torch.app.driver import App
    from shader_ray_tpu_torch.app.main import repl
    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.ops.render import RenderStatics
    from shader_ray_tpu_torch.utils.ppm import read_ppm

    app = App(bench_world(), renderer, renderer.cfg, width=W, height=H)
    frames, runs = [], []

    def recorded(fn, what):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if what == "benchmark":
                runs.append([d * 1e3 for d in out])
            else:
                frames.append((what, app.which, app.frame_params(), out))
            return out
        return call

    app.draw_frame = recorded(app.draw_frame, "frame")
    app.render_progressive = recorded(app.render_progressive, "progressive")
    app.benchmark = recorded(app.benchmark, "benchmark")
    cwd = os.getcwd()
    _build.LAUNCHES.clear()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            repl(app, "frame.ppm", io.StringIO("\n".join(APP_SCRIPT) + "\n"))
            torch.cuda.synchronize()
            t_repl = time.perf_counter() - t0
            shot = read_ppm("color.ppm")
        finally:
            os.chdir(cwd)
    app_launches = dict(_build.LAUNCHES)
    whiches = [w for _, w, _, _ in frames]
    print(f"app: REPL script of {len(APP_SCRIPT)} commands in {t_repl:.2f} s: {len(frames)} frames "
          f"(which {whiches}), screenshot {shot.shape}, launches {app_launches}")
    bad = [(what, w) for what, w, _, f in frames if f.shape != (H, W, 3) or not np.isfinite(f).all()]
    # every frame the App drew came to the host by the pinned route
    if bad or shot.shape != (H, W, 3) or set(app_launches) != {"frame_kernel", "copy_to_host:pinned"} \
            or app_launches["copy_to_host:pinned"] != len(frames) or 5 not in whiches:
        raise AssertionError(f"app: frames off shape or non-finite {bad}, or launches {app_launches}")
    _, _, p5, f5 = next(x for x in frames if x[1] == 5)
    want = renderer.make_fn(RenderStatics.from_config(renderer.cfg, width=W, height=H, which=5))(p5)
    d5 = float(np.abs(f5 - want.cpu().numpy()).max())
    print(f"app: its which=5 frame vs make_fn's for the same params: max abs {d5:.3e} (limit 1e-6)")
    if d5 > 1e-6:
        raise AssertionError("app: the which=5 frame is not make_fn's")
    (b_ms,) = runs
    print(f"app: b histogram on {card}: median {np.median(b_ms):.3f} ms, p95 "
          f"{np.percentile(b_ms, 95):.3f} ms, n={len(b_ms)} (host clock, a device synchronize "
          f"each frame, which={app.which})")

    # the CLI once, as a user runs it
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "frame.ppm")
        env = {**os.environ, "PYTHONPATH": ROOT, "SRT_CACHE_DIR": os.path.join(tmp, "cache")}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "shader_ray_tpu_torch",
             os.path.join(ROOT, "tests", "assets", "knot.obj"), "grid", "--once", "--out", out],
            capture_output=True, text=True, timeout=300, env=env, cwd=tmp)
        img = read_ppm(out) if proc.returncode == 0 else None
    print(f"CLI: python -m shader_ray_tpu_torch knot.obj grid --once: rc {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s, frame {None if img is None else img.shape}, "
          f"std {0.0 if img is None else float(img.std()):.1f}")
    if img is None or img.shape != (512, 512, 3) or img.std() < 10:
        raise AssertionError(f"CLI failed: {proc.stderr[-2000:]}")
    return b_ms


def bmp_bytes(px) -> bytes:
    """A 24-bit bottom-up BITMAPINFOHEADER BMP of (H, W, 3) uint8 pixels."""
    import struct

    import numpy as np

    h, w, _ = px.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = px[::-1, :, ::-1].reshape(h, w * 3)  # bottom-up, BGR
    pix = rows.tobytes()
    return (b"BM" + struct.pack("<IHHI", 54 + len(pix), 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pix), 2835, 2835, 0, 0) + pix)


def tga_bytes(px) -> bytes:
    """A raw 24-bit top-down TGA (type 2) of (H, W, 3) uint8 pixels."""
    import struct

    h, w, _ = px.shape
    return struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0x20) + \
        px[..., ::-1].tobytes()


JPEG_ASSET = os.path.join(ROOT, "tests", "assets", "sky.jpg")  # baseline, 4:2:0, 192x96
SERVE_LIMIT = 120.0  # seconds the viewer's client may take, and run() to return after it


def images_phase(data) -> dict:
    """A PNG written by the port's encoder, a BMP and a TGA written here and
    the committed JPEG, each through ``load_background``: the PNG, BMP and
    TGA must give their pixels / 255 exactly, the JPEG the committed decode
    of the JAX package's reader (tests/assets/sky.jpg.npy) / 255 exactly.
    Then one W x H App frame over the JPEG env, bit for bit the frame over
    the same pixels passed as .npy.  Returns the path's launch counts."""
    import tempfile

    import numpy as np
    import torch

    from shader_ray_tpu_torch.app.driver import App
    from shader_ray_tpu_torch.engine import Renderer
    from shader_ray_tpu_torch.models.background import load_background
    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.utils.png import encode_png

    px = np.random.default_rng(3).integers(0, 256, size=(48, 96, 3), dtype=np.uint8)
    px[:16] = px[0, 0]  # a flat band beside the noise
    with tempfile.TemporaryDirectory() as tmp:
        for ext, body in (("png", encode_png(px)), ("bmp", bmp_bytes(px)), ("tga", tga_bytes(px))):
            path = os.path.join(tmp, f"env.{ext}")
            with open(path, "wb") as f:
                f.write(body)
            got = load_background(path)
            same = got.dtype == np.float32 and np.array_equal(got, px.astype(np.float32) / 255.0)
            print(f"images: .{ext} ({len(body)} bytes) through load_background: {got.shape}, "
                  f"equal to its pixels / 255: {same}")
            if not same:
                raise AssertionError(f"images: the .{ext} background is not its pixels")
        env_j = load_background(JPEG_ASSET)
        want = np.load(JPEG_ASSET + ".npy").astype(np.float32) / 255.0
        same = env_j.dtype == np.float32 and np.array_equal(env_j, want)
        print(f"images: {os.path.relpath(JPEG_ASSET, ROOT)} through load_background: {env_j.shape}, "
              f"equal to the committed decode / 255: {same}")
        if not same:
            raise AssertionError("images: the JPEG decode is not the committed one")
        npy = os.path.join(tmp, "sky.npy")
        np.save(npy, env_j)
        _build.LAUNCHES.clear()
        frames = []
        for spec in (JPEG_ASSET, npy):
            renderer = Renderer(data, load_background(spec))
            frames.append(App(bench_world(), renderer, renderer.cfg, width=W, height=H).render())
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    same = frames[0].shape == (H, W, 3) and frames[0].tobytes() == frames[1].tobytes()
    print(f"images: App {W}x{H} frame over the JPEG env, bit for bit the frame over its .npy: "
          f"{same}; mean {float(frames[0].mean()):.4f}; launches {launches}")
    if not same or not np.isfinite(frames[0]).all() \
            or launches != {"frame_kernel": 2, "copy_to_host:pinned": 2}:
        raise AssertionError("images: the App frame over the JPEG env")
    return launches


def serve_phase(renderer, card: str) -> dict:
    """The browser viewer over an App on the bench scene at W x H, on
    127.0.0.1 port 0.  This thread renders (``step``, ``run``); a client
    thread fetches ``/`` and ``/state``, then ``/frame.png`` (its decode
    must be the App's frame quantized, byte for byte), posts the key m
    and a drag (the serial must advance and a different frame be served),
    then the key q; ``run()`` must return within SERVE_LIMIT seconds.
    Times ``step()`` split into the render and ``encode_png``.  Returns
    the path's launch counts and the times."""
    import json as js
    import threading
    import urllib.request

    import numpy as np
    import torch

    from shader_ray_tpu_torch.app import webview
    from shader_ray_tpu_torch.app.driver import App
    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.utils.png import decode_png, encode_png

    app = App(bench_world(), renderer, renderer.cfg, width=W, height=H)
    render_ms, encode_ms = [], []

    def timed(fn, out):
        def call(*args, **kw):
            t0 = time.perf_counter()
            r = fn(*args, **kw)
            out.append((time.perf_counter() - t0) * 1e3)
            return r
        return call

    app.draw_frame = timed(app.draw_frame, render_ms)  # ends in .cpu(): synchronized
    webview.encode_png = timed(encode_png, encode_ms)
    _build.LAUNCHES.clear()
    viewer = webview.WebViewer(app, host="127.0.0.1", port=0)
    url = viewer.start()
    done, errors, quit_at = [], [], []

    def get(path):
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.read()

    def post(ev):
        req = urllib.request.Request(url + "event", data=js.dumps(ev).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.read()

    def wait_serial(above, deadline):
        while True:
            st = js.loads(get("state"))
            if st["serial"] > above or time.time() > deadline:
                return st
            time.sleep(0.01)

    def client():
        try:
            deadline = time.time() + SERVE_LIMIT
            page, st = get(""), js.loads(get("state"))
            done.append(f"GET / {len(page)} bytes, /state {st}")
            st = wait_serial(0, deadline)
            png0 = get("frame.png")
            frame0 = decode_png(png0)
            want = (np.clip(app._frame, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            if frame0.shape != (H, W, 3) or not np.array_equal(frame0, want):
                raise AssertionError("/frame.png is not the App's frame")
            done.append(f"GET /frame.png {len(png0)} bytes = the App's frame, serial {st['serial']}")
            for ev in ({"type": "key", "k": "m"},
                       {"type": "button", "pressed": True, "x": W // 2, "y": H // 2},
                       {"type": "motion", "x": W // 2 + 8, "y": H // 2},
                       {"type": "motion", "x": W // 2 + 200, "y": H // 2 + 60},
                       {"type": "button", "pressed": False}):
                post(ev)
            png1, serial0 = png0, st["serial"]
            while png1 == png0 and time.time() < deadline:
                st = wait_serial(st["serial"], deadline)
                png1 = get("frame.png")
            material = js.loads(get("state"))["material"]
            if st["serial"] <= serial0 or png1 == png0 or material != "silver":
                raise AssertionError(f"no new frame after m and a drag (serial {st['serial']}, "
                                     f"material {material})")
            done.append(f"POST m and a drag: serial {serial0} -> {st['serial']}, a new frame "
                        f"({len(png1)} bytes), material {material}")
            quit_at.append(time.perf_counter())
            post({"type": "key", "k": "q"})
        except Exception as e:  # reported by the rendering thread
            errors.append(repr(e))
        finally:
            app.quit = True  # the loop ends whatever failed

    t0 = time.perf_counter()
    try:
        viewer.step()  # the first frame, before any client
        thread = threading.Thread(target=client, daemon=True)
        thread.start()
        viewer.run(poll=0.005)
        returned = time.perf_counter()
        thread.join(SERVE_LIMIT)
    finally:
        viewer.stop()
        webview.encode_png = encode_png
        del app.draw_frame
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for line in done:
        print(f"serve: {line}")
    after_q = (returned - quit_at[0]) * 1e3 if quit_at else float("nan")
    print(f"serve: run() returned {after_q:.1f} ms after the q was posted; "
          f"{time.perf_counter() - t0:.2f} s in all; launches {launches}")
    if errors or thread.is_alive() or not quit_at or launches.get("frame_kernel", 0) < 2:
        raise AssertionError(f"serve: {errors or 'the client did not finish'}, launches {launches}")
    # steady frames of the App's view: the render (frame kernel and the copy
    # to the host) and the PNG encode, as step() does them
    app.redraw = True
    steady_r = host_times(lambda: app.draw_frame(), 10)
    frame = app._frame
    steady_e = []
    for _ in range(10):
        t1 = time.perf_counter()
        encode_png(frame)
        steady_e.append((time.perf_counter() - t1) * 1e3)
    r_ms, e_ms = float(np.median(steady_r)), float(np.median(steady_e))
    print(f"serve: step() on {card}: render (make_fn, copy to the host) {summary(steady_r)}; "
          f"encode_png {W}x{H} {summary(steady_e)} (host clock); in the loop above: render "
          f"{[round(x, 2) for x in render_ms]} ms, encode {[round(x, 2) for x in encode_ms]} ms; "
          f"{1e3 / (r_ms + e_ms):.1f} frames/s at most")
    return {"launches": launches, "render_ms": r_ms, "encode_ms": e_ms}


# the build log's lines of a scene-cache miss (a hit builds no BVH and
# flattens nothing); both runs print the scene's center and extent line, as
# the reference's load_world does before it skips the build
CLI_BUILD_LOG = ("BVH (native): ", "hitmiss: ")


def cli_cache_phase() -> None:
    """``python -m shader_ray_tpu_torch knot.obj sky.jpg --once`` twice with
    one SRT_CACHE_DIR: the first builds and stores the scene and prints the
    reference's build log, the second says it hit the cache and prints no
    build; the two frames are equal."""
    import tempfile

    import numpy as np

    from shader_ray_tpu_torch.utils.ppm import read_ppm

    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "PYTHONPATH": ROOT, "SRT_CACHE_DIR": os.path.join(tmp, "cache")}
        frames, hits, logs = [], [], []
        for run in (1, 2):
            out = os.path.join(tmp, f"frame{run}.ppm")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "shader_ray_tpu_torch",
                 os.path.join(ROOT, "tests", "assets", "knot.obj"), JPEG_ASSET, "--once", "--out", out],
                capture_output=True, text=True, timeout=300, env=env, cwd=tmp)
            hit = "scene cache hit" in proc.stderr
            frames.append(read_ppm(out) if proc.returncode == 0 else None)
            hits.append(hit)
            lines = proc.stderr.splitlines()
            logs.append({head: any(x.startswith(head) for x in lines)
                         for head in ("Finding scene center and extent: ", *CLI_BUILD_LOG)})
            print(f"cli: run {run}: knot.obj sky.jpg --once: rc {proc.returncode} in "
                  f"{time.perf_counter() - t0:.1f} s, scene cache hit {hit}, frame "
                  f"{None if frames[-1] is None else frames[-1].shape}; build log lines {logs[-1]}")
            if run == 1:
                print("cli: run 1 stderr:\n  " + "\n  ".join(lines[:12]))
            if proc.returncode != 0:
                raise AssertionError(f"cli run {run} failed: {proc.stderr[-2000:]}")
        cached = os.listdir(os.path.join(tmp, "cache"))
    same = np.array_equal(frames[0], frames[1])
    print(f"cli: cache files {cached}; the two frames equal: {same}, std {float(frames[0].std()):.1f}")
    if hits != [False, True] or not same or frames[0].shape != (512, 512, 3) or frames[0].std() < 10:
        raise AssertionError("cli: the second run did not hit the scene cache, or the frames differ")
    if not all(logs[0].values()) or any(logs[1][head] for head in CLI_BUILD_LOG):
        raise AssertionError(f"cli: the cold run's build log is not whole, or the cache hit built: {logs}")


def mesh_phase(data, sky, params, singles: dict, card: str) -> dict:
    """Multi-device rendering on the bench scene at W x H: meshes
    [cuda:0] and [cuda:0, cuda:0] (two shards on the one card).  Each
    ray-sharded make_fn frame (fused which 0, 1 with aniso 4 and 5; the
    unfused route on wide and on binary tables at which 0) equals the
    single-device given-rays frame of the same rays bit for bit, and the
    tonemapped frames pass the bench golden; a sample-sharded K = BATCH_K
    progressive mean is held to the unsharded one within 1e-6 (max abs,
    linear); both timed; then the CLI with --devices 1, and with one more
    device than the machine has, refused with both numbers.  The
    references are rendered before the launch counts are set to 0."""
    import tempfile

    import numpy as np
    import torch

    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.engine import Renderer
    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.ops.engine_frame import frame_jitter, render_linear
    from shader_ray_tpu_torch.ops.render import RenderStatics
    from shader_ray_tpu_torch.utils.ppm import read_ppm

    cuda0 = torch.device("cuda", 0)
    meshes = {"[cuda:0]": [cuda0], "[cuda:0, cuda:0]": [cuda0, cuda0]}
    routes = {"fused": Config(), "unfused wide": Config(packet_fused=False),
              "binary": Config(packet_kernel="binary")}
    cases = [("fused", 0, 1), ("fused", 1, 4), ("fused", 5, 1), ("unfused wide", 0, 1), ("binary", 0, 1)]
    linear = RenderStatics(width=W, height=H, do_tonemap=False)
    want = {}
    for route, which, aniso in cases:
        r, st = singles[route], linear._replace(which=which, env_aniso=aniso)
        want[route, which] = render_linear(r.packed, params, st, frame_jitter(params), r.cfg,
                                           rows=(0, H))
    t0 = time.perf_counter()
    sharded = {(m, route): Renderer(data, sky, cfg, mesh=mesh)
               for m, mesh in meshes.items() for route, cfg in routes.items()}
    torch.cuda.synchronize()
    print(f"mesh: 6 Renderers (3 routes x 2 meshes) packed and replicated in "
          f"{time.perf_counter() - t0:.2f} s")
    _build.LAUNCHES.clear()
    for (m, route), r in sharded.items():
        for case_route, which, aniso in cases:
            if case_route != route:
                continue
            st = linear._replace(which=which, env_aniso=aniso)
            before = dict(_build.LAUNCHES)
            got = r.make_fn(st)(params)
            torch.cuda.synchronize()
            added = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items() if n != before.get(k, 0)}
            same = torch.equal(got, want[route, which])
            print(f"mesh {m}, {route} which={which}: sharded make_fn vs the single-device given-rays "
                  f"frame bit for bit: {same} (max abs {float((got - want[route, which]).abs().max()):.3e}); "
                  f"launches {added}")
            if not same:
                raise AssertionError(f"mesh {m}: the sharded {route} which={which} frame is not the "
                                     "given-rays frame")
            if which in (0, 5):
                gold = GOLDEN5 if which == 5 else GOLDEN
                golden_gate(r.make_fn(st._replace(do_tonemap=True))(params).cpu().numpy(), gold,
                            f"mesh {m}, {route} which={which}")
    # sample sharding: K = BATCH_K over two shards, against one device
    two, one = sharded["[cuda:0, cuda:0]", "fused"], singles["fused"]
    prog2 = two.make_progressive_fn(linear, BATCH_K)
    prog1 = one.make_progressive_fn(linear, BATCH_K)
    a, b = prog2(params), prog1(params)
    torch.cuda.synchronize()
    diff = (a - b).abs()
    err = float(diff.max())
    # the two sum the same 64 samples in another order: f32 spacing grows
    # with the value (1.9e-6 between 16 and 32), so the bound is 1e-6 of
    # the value above 1 and 1e-6 absolute below it
    scaled = float((diff / b.abs().clamp_min(1.0)).max())
    print(f"mesh [cuda:0, cuda:0]: sample-sharded K={BATCH_K} ({BATCH_K // 2} a shard) vs unsharded "
          f"K={BATCH_K}: max abs {err:.3e} on linear colour up to {float(b.max()):.2f}, pixels over "
          f"1e-6 absolute: {int((diff > 1e-6).any(-1).sum())}; max abs / max(1, |value|) "
          f"{scaled:.3e} (limit 1e-6)")
    t = {"1": [], "2": []}
    for k in ("1", "2", "2", "1"):  # in turns on one card
        t[k] += host_times(lambda: (prog1 if k == "1" else prog2)(params), 5)
    print(f"  K={BATCH_K} progressive on {card} (host clock, synchronized): unsharded "
          f"{summary(t['1'])}; sample-sharded over two shards {summary(t['2'])}")
    statics = linear._replace(do_tonemap=True)
    frames = {name: r.make_fn(statics) for name, r in (("one device", one),
                                                        ("[cuda:0]", sharded["[cuda:0]", "fused"]),
                                                        ("[cuda:0, cuda:0]", two))}
    ft = {name: [] for name in frames}
    for name in (*frames, *reversed(frames)):
        ft[name] += host_times(lambda: frames[name](params), TIMED // 2)
    print(f"  make_fn {W}x{H} which=0 on {card} (host clock, synchronized per frame, in turns): "
          + "; ".join(f"{name} {summary(ms)}" for name, ms in ft.items()))
    launches = dict(_build.LAUNCHES)
    print(f"mesh path launches: {launches}")
    if set(launches) != {"frame_kernel", "trace_wide", "trace_binary", "env_sample"}:
        raise AssertionError("the mesh path must launch frame_kernel, trace_wide, trace_binary "
                             "and env_sample")
    if scaled > 1e-6:
        raise AssertionError(f"sample-sharded K={BATCH_K} strays {scaled:.3e} of the value from the "
                             "unsharded mean")

    # the CLI: --devices 1, and one more device than this machine has
    more = torch.cuda.device_count() + 1
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "PYTHONPATH": ROOT, "SRT_CACHE_DIR": os.path.join(tmp, "cache")}
        rcs, errs_ = {}, {}
        for n in (1, more):
            out = os.path.join(tmp, f"frame{n}.ppm")
            proc = subprocess.run(
                [sys.executable, "-m", "shader_ray_tpu_torch",
                 os.path.join(ROOT, "tests", "assets", "knot.obj"), "grid", "--once",
                 "--devices", str(n), "--out", out],
                capture_output=True, text=True, timeout=300, env=env, cwd=tmp)
            rcs[n], errs_[n] = proc.returncode, proc.stderr
            img = read_ppm(out) if proc.returncode == 0 else None
            print(f"CLI --devices {n}: rc {proc.returncode}, frame "
                  f"{None if img is None else img.shape}; stderr tail: "
                  f"{proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else ''}")
    refusal = f"{more} device(s) asked for, but this machine has {more - 1} CUDA device(s)"
    if rcs[1] != 0 or rcs[more] == 0 or refusal not in errs_[more]:
        raise AssertionError(f"CLI --devices: 1 must render and {more} be refused: {errs_}")
    return {"launches": launches, "k64_ms": float(np.median(t["1"])),
            "k64_sample_sharded_ms": float(np.median(t["2"])), "k64_max_abs": err,
            "k64_max_scaled": scaled,
            **{f"make_fn_{name}_ms": float(np.median(ms)) for name, ms in ft.items()}}


def native_phase(sky, params, g_build_s: float, card: str) -> dict:
    """The native scene builder: its g++ build seconds (timed beside the
    nvcc builds), the bench scene through the native and the numpy
    builder with ``verbose=True``, both timed and equal on every SceneData
    array, the numpy build's ``BVHStats`` block, the native build's printed
    node and leaf counts held to those stats, and the fused frame over the
    native tables through the golden gate."""
    import contextlib
    import io

    import numpy as np
    import torch

    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.engine import Renderer
    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.ops.render import RenderStatics

    ts = TriangleSet.from_arrays(*bunny_class_scene(69000))
    built, secs, logs, stats = {}, {}, {}, None
    for way in ("require", "never", "require", "never"):
        cfg = Config(use_native=way)
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            w = make_world(ts, cfg, verbose=True)
            built[way] = get_shader_data(w, cfg, verbose=True)
        secs.setdefault(way, []).append(time.perf_counter() - t0)
        logs.setdefault(way, err.getvalue().splitlines())
        stats = w.bvh.stats if way == "never" else stats
    log = logs["never"]
    at = next(i for i, x in enumerate(log) if x.startswith("BVH: "))
    end = next(i for i, x in enumerate(log) if x.startswith("hitmiss: "))
    print("native: the numpy build's log (verbose=True), first run:\n  " + "\n  ".join(log[at:end + 1]))
    nat = logs["require"]
    counts = [int(x.split()[0]) for x in nat if x.endswith(" bvh nodes") or x.endswith(" of those are leaves")]
    print("native: the native build's log, first run:\n  " + "\n  ".join(nat[-4:]))
    print(f"native: printed node and leaf counts {counts} against the numpy build's stats "
          f"{[stats.node_count, stats.leaf_count]}")
    if counts != [stats.node_count, stats.leaf_count] or not nat[-4].startswith("BVH (native): "):
        raise AssertionError("native: the native build's printed counts are not the numpy build's stats")
    fields = ("tri_positions", "tri_normals", "tri_colors", "node_boxes", "node_objects",
              "node_children", "node_axis", "hitmiss")
    same = {f: getattr(built["require"], f).tobytes() == getattr(built["never"], f).tobytes()
            for f in fields}
    ints = all(getattr(built["require"], f) == getattr(built["never"], f)
               for f in ("tree_root", "triangle_count", "group_count"))
    print(f"native: g++ build of libscene {g_build_s:.2f} s; bench scene BVH + flatten on the card's "
          f"host ({card}): native {secs['require'][0]:.3f}, {secs['require'][1]:.3f} s, numpy "
          f"{secs['never'][0]:.3f}, {secs['never'][1]:.3f} s (verbose, stats printed; quiet "
          f"builds on this card's hosts before the stats existed: native 0.05-0.07 s, numpy "
          f"3.6-4.5 s, PERF.md); every SceneData array equal: {same}, "
          f"root and counts equal: {ints}")
    if not all(same.values()) or not ints:
        raise AssertionError("native: the native build is not the numpy build")
    _build.LAUNCHES.clear()
    golden_gate(Renderer(built["require"], sky).make_fn(RenderStatics(width=W, height=H))(params)
                .cpu().numpy(), GOLDEN, "fused which=0 over the native tables")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"native path launches: {launches}")
    if launches != {"frame_kernel": 1}:
        raise AssertionError("native: the frame over the native tables is one frame_kernel launch")
    return {"launches": launches, "g++_s": g_build_s, "native_s": float(np.median(secs["require"])),
            "numpy_s": float(np.median(secs["never"])), "bvh_nodes": stats.node_count,
            "bvh_leaves": stats.leaf_count}


QUALITY_SIZE = (256, 192, 4)  # width, height, tile_stride: packets 0, 4 and 8 of 12


def quality_phase(data) -> None:
    """The tree-quality simulator (models/quality.py) on the bench scene
    for collapse sah and greedy at QUALITY_SIZE (a numpy walk; the full
    frame takes minutes): per-phase steps and leaf visits a packet."""
    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.models.quality import simulate_frame

    w, h, stride = QUALITY_SIZE
    for collapse in ("sah", "greedy"):
        t0 = time.perf_counter()
        res = simulate_frame(data, width=w, height=h, tile_stride=stride,
                             config=Config(collapse=collapse))
        print(f"quality: simulate_frame {w}x{h}, tile_stride={stride} ({res.phases[0].packets} "
              f"packets of 4096 rays), collapse={collapse}, in {time.perf_counter() - t0:.1f} s: "
              + ", ".join(f"{p.name} {p.steps_per_pkt:.1f} steps {p.leafs_per_pkt:.1f} leafs"
                          for p in res.phases)
              + f"; total {res.total_steps_per_pkt:.1f} steps, {res.total_leafs_per_pkt:.1f} leafs a packet")
        if res.total_steps_per_pkt <= 0:
            raise AssertionError("quality: the simulated walk took no step")


def diag_phase(renderer, params) -> dict:
    """The failure dump, debug_nans and the profiler trace on the card: a
    launch the kernel's C entry refuses (bounce_count = -1) prints the
    dump naming frame_kernel and raises; under Config.debug_nans a
    which = 1 frame with a ray exactly along +y raises FloatingPointError
    and the bench frame does not; device_trace writes a trace naming
    frame_kernel."""
    import contextlib
    import io
    import tempfile

    import torch

    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.ops.render import RenderStatics
    from shader_ray_tpu_torch.utils.profiling import device_trace

    statics = RenderStatics(width=W, height=H)
    _build.LAUNCHES.clear()
    dump = io.StringIO()
    raised = None
    with contextlib.redirect_stderr(dump):
        try:
            renderer.make_fn(statics._replace(bounce_count=-1))(params)
        except RuntimeError as e:
            raised = e
    text = dump.getvalue()
    print("diag: a refused launch (bounce_count=-1): raised "
          f"{type(raised).__name__ if raised else None}: {raised}; the dump:\n" + text.rstrip())
    if raised is None or "kernel: frame_kernel" not in text or "bounce_count=-1" not in text:
        raise AssertionError("diag: the refused launch did not raise with the dump")
    # the camera looks up +y; at the jitter (0.5, 0.5) pixel (h/2 - 1, W/2 - 1)'s
    # ray is exactly (0, 1, 0) where 1/h is exact in f32: h = 512
    up = torch.tensor([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=torch.float32)
    along_y = params._replace(camera_normal_matrix=up, pixel_jitter=torch.tensor([0.5, 0.5]))
    renderer.cfg.debug_nans = True
    try:
        renderer.make_fn(statics)(params)  # the bench frame: silent
        try:
            renderer.make_fn(statics._replace(which=1, env_aniso=4, height=512))(along_y)
            nan_error = None
        except FloatingPointError as e:
            nan_error = e
    finally:
        renderer.cfg.debug_nans = False
    print(f"diag: debug_nans on the bench frame: silent; on a {W}x512 which=1 frame with pixel "
          f"(255, {W // 2 - 1})'s ray along +y: {type(nan_error).__name__ if nan_error else None}: "
          f"{nan_error}")
    if nan_error is None:
        raise AssertionError("diag: debug_nans did not raise on the +y grad frame")
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            renderer.make_fn(statics)(params)
        (name,) = os.listdir(tmp)
        trace = open(os.path.join(tmp, name)).read()
    kernels = trace.count('"cat": "kernel"')
    named = '"frame_kernel"' in trace
    print(f"diag: device_trace wrote {name} ({len(trace)} bytes, {kernels} device kernel events); "
          f"names frame_kernel: {named}")
    if not named:
        raise AssertionError("diag: the trace does not name frame_kernel")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"diag path launches: {launches}")
    return {"launches": launches}


BENCH_FIELDS = ("metric", "value", "unit", "rays_potential", "rays_cast", "mrays_per_s_cast",
                "frame_ms", "frame_ms_single_dispatch", "frames_per_dispatch", "occluded", "which1",
                "large_340k", "device")
BENCH_K = 1024  # the bench's default batch (bench.py:50)
BENCH_SLICE = 64  # the K = BENCH_K mean is held to BENCH_K // BENCH_SLICE launches of this many


def bench_phase(renderer, params, cast: int, k64_ms: float, make_fn_ms: float, card: str) -> dict:
    """The port's bench, ``python -m shader_ray_tpu_torch.bench`` at its
    defaults (bench69k, K = BENCH_K, the sub-metrics on) under
    BENCH_TUNE=0 (the shipped launch shape), as a subprocess
    with the build directory warm and a fresh SRT_CACHE_DIR: exit 0,
    "golden gate: ok" on its stderr, every field of its JSON line (printed
    here) and no error in it, its rays_cast equal to this run's count at
    the bench camera, and the frame kernel the only kernel it launched (the
    counts it prints on stderr; this process launches nothing meanwhile).
    Then the linear mean over halton_jitters(BENCH_K) in one launch held to
    the mean of BENCH_K // BENCH_SLICE launches over its slices, and the
    bench's times printed beside this run's K = 64 and make_fn times (for
    the reader, no gate)."""
    import tempfile

    import numpy as np
    import torch

    from shader_ray_tpu_torch.bench import has_error
    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.ops.engine_frame import halton_jitters, render_linear
    from shader_ray_tpu_torch.ops.render import RenderStatics

    _build.LAUNCHES.clear()
    with tempfile.TemporaryDirectory() as tmp:
        env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
        # the shipped launch shape: no tune applied (the tune phase runs the rest)
        env.update(PYTHONPATH=ROOT, SRT_CACHE_DIR=os.path.join(tmp, "cache"), BENCH_TUNE="0")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "shader_ray_tpu_torch.bench"],
                              capture_output=True, text=True, timeout=600, env=env, cwd=tmp)
        secs = time.perf_counter() - t0
    print(f"bench: python -m shader_ray_tpu_torch.bench, rc {proc.returncode} in {secs:.1f} s; "
          "its stderr:\n" + "\n".join(f"  {s}" for s in proc.stderr.rstrip().splitlines()))
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if lines else {}
    print(f"bench: {json.dumps(out)}")
    launches = next((json.loads(s[len("launches: "):]) for s in proc.stderr.splitlines()
                     if s.startswith("launches: ")), {})
    print(f"bench path launches (the bench's own counts): {launches}; this process: "
          f"{dict(_build.LAUNCHES)}")
    missing = [f for f in BENCH_FIELDS if f not in out]
    if proc.returncode != 0 or "golden gate: ok" not in proc.stderr or missing or has_error(out):
        raise AssertionError(f"bench: rc {proc.returncode}, golden gate ok "
                             f"{'golden gate: ok' in proc.stderr}, missing fields {missing}, "
                             f"error {has_error(out)}")
    if (out["rays_potential"], out["frames_per_dispatch"], out["rays_cast"]) != (W * H * 6, BENCH_K, cast):
        raise AssertionError(f"bench: rays_potential {out['rays_potential']}, frames_per_dispatch "
                             f"{out['frames_per_dispatch']}, rays_cast {out['rays_cast']} (this run's "
                             f"count {cast})")
    if out["device"]["name"] != torch.cuda.get_device_name(0) or \
            not isinstance(out["device"]["power_limit_w"], float):
        raise AssertionError(f"bench: device {out['device']}")
    if set(launches) != {"frame_kernel"} or launches["frame_kernel"] < 1 or _build.LAUNCHES:
        raise AssertionError("bench: the bench must launch frame_kernel and nothing else")

    # a thread sums its K samples in order, so the one launch and the
    # slices differ only in the order of their f32 sums of the same
    # samples (non-negative colour): sequential sums of n terms err by at
    # most (n - 1) * 2^-24 of the sum, and /K, /64, /16 are exact, so the
    # two means lie within (K - 1 + 63 + 15) * 2^-24 of the value
    linear = RenderStatics(width=W, height=H, do_tonemap=False)
    jit = torch.from_numpy(halton_jitters(BENCH_K)).cuda()
    run = lambda j: render_linear(renderer.packed, params, linear, j, renderer.cfg)
    whole = run(jit)
    parts = torch.stack([run(jit[i:i + BENCH_SLICE]) for i in range(0, BENCH_K, BENCH_SLICE)])
    sliced = parts.sum(0) / parts.shape[0]
    torch.cuda.synchronize()
    limit = (BENCH_K - 1 + BENCH_SLICE - 1 + parts.shape[0] - 1) * 2.0 ** -24
    scale = torch.maximum(whole.abs(), sliced.abs())
    diff = (whole - sliced).abs()
    rel = float((diff / scale.clamp_min(1e-30)).max())
    print(f"bench: K={BENCH_K} linear mean (one launch) vs the mean of {parts.shape[0]} launches of "
          f"K={BENCH_SLICE} over its slices: max abs {float(diff.max()):.3e}, max rel {rel:.3e} "
          f"(limit {limit:.3e}), pixels differing {int((diff > 0).any(-1).sum())} of {W * H}, "
          f"smallest value {float(torch.minimum(whole, sliced).min()):.3e}")
    if not torch.isfinite(whole).all() or bool((diff > limit * scale).any()):
        raise AssertionError(f"bench: the K={BENCH_K} mean strays from its slices beyond {limit:.3e}")
    print(f"bench on {card}: time a sample at K={BENCH_K} {out['frame_ms']} ms (host clock, median of "
          f"batches) beside this run's K={BATCH_K} kernel {k64_ms:.3f} ms a sample (CUDA events); "
          f"single frame {out['frame_ms_single_dispatch']} ms (make_checksum_fn, host clock, "
          f"median of 5) beside make_fn's {make_fn_ms:.3f} ms (host clock, median of {TIMED}); "
          f"occluded {out['occluded']['frame_ms']} ms, which1 {out['which1']['frame_ms']} ms, "
          f"large_340k {out['large_340k']['frame_ms']} ms a sample; phase {secs:.1f} s")
    return {"launches": launches, "seconds": secs, "out": out, "k_mean_rel": rel}


# the frame kernel's launch shapes (Config.frame_tile, frame_warp), the
# default first; utils/autotune.DEFAULT_SPACE searches them
FRAME_SHAPES = tuple((w, m) for w in (16, 32, 8, 64) for m in ("rows", "bricks"))
TUNE_SMALL = (256, 192)  # the frame whose per-tile rows are held to frame_plain's
TUNE_K = 64  # samples of App.tune's batches, and of the shapes' per-sample times


def bits(x):
    """A float tensor's bit patterns, for bit-for-bit comparisons (NaN too)."""
    import torch

    return x.contiguous().view(dtype=torch.int32)


def block_of(uni):
    """The (UNI_SIZE,) uniform table ``uni`` as the frame kernel's host
    block (ops/frame_kernel.frame_kernel), beside a zero jitter."""
    import numpy as np

    from shader_ray_tpu_torch.ops.frame_kernel import UNI_BLOCK, UNI_SIZE

    block = np.zeros(UNI_BLOCK, np.float32)
    block[:UNI_SIZE] = uni.cpu().numpy()
    return block


def routed(packed, params, fs, jitters=None, rays=None):
    """A launch of the frame kernel as the routes make it: a new host
    block filled from ``params`` at each call (the uniforms, and with
    neither ``jitters`` nor ``rays`` the frame's jitter, by value), the
    launch's fixed part from the tables' cache."""
    import numpy as np

    from shader_ray_tpu_torch.ops import frame_kernel as fk
    from shader_ray_tpu_torch.ops.engine_frame import fill_uniforms

    new_block = lambda: np.zeros(fk.UNI_BLOCK, np.float32)
    return lambda: fk.frame_kernel(packed, fill_uniforms(new_block(), params), jitters, fs, rays=rays)


def tile_rows_disagreement(kr, pr) -> str | None:
    """Why the kernel's per-tile rows disagree with the plain version's at
    the same shape, or None.  A grazing ray that flips (nvcc's FMAs)
    changes its own tile's row only: at most max(2, tiles / 500) tiles may
    differ, each by at most 2 rays cast.  A wrong pixel map moves whole
    rows of pixels between tiles, which this refuses."""
    if kr.shape != pr.shape:
        return f"rows {tuple(kr.shape)} vs {tuple(pr.shape)}"
    differ = (kr != pr).any(1)
    n, limit = int(differ.sum()), max(2, kr.shape[0] // 500)
    cast = int((kr[:, 0] - pr[:, 0]).abs().max()) if kr.numel() else 0
    if n > limit or cast > 2:
        return f"{n} tiles differ (limit {limit}), rays cast by up to {cast} in a tile"
    return None


def tune_phase(renderer, params, card: str) -> dict:
    """The frame kernel's launch shapes and the autotune over them, on the
    bench scene, under a temporary SRT_CACHE_DIR that is removed after:
    (a) every shape of FRAME_SHAPES in which = 0 K = 1, which = 1 aniso 4
    and the given-rays form, each launch's linear colour and counter row
    bit for bit the default launch's, and on a TUNE_SMALL frame its
    per-tile rows summing to its row and held to frame_plain's at the
    same shape; a shape the kernel has not raises, and inside a search is
    a failed candidate; (b) each shape timed with CUDA events, K = 1 (n =
    TIMED) and a sample of K = TUNE_K, in turns, beside its registers and
    blocks an SM; (c) App.tune(TUNE_K) applying a winner, then a cache hit
    that launches nothing; (d) the bench under BENCH_TUNE=1 then
    BENCH_TUNE=auto (sub-metrics off), each through its golden gate, the
    second applying the first's tune."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from shader_ray_tpu_torch.app.driver import App
    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.ops import frame_kernel as fk
    from shader_ray_tpu_torch.ops.engine_frame import halton_jitters, pack_uniforms
    from shader_ray_tpu_torch.ops.render import RenderStatics
    from shader_ray_tpu_torch.utils.autotune import autotune

    t_phase = time.perf_counter()
    packed = renderer.packed
    uni = pack_uniforms(params).cuda()
    blk = block_of(uni)
    one = torch.zeros((1, 2), dtype=torch.float32, device="cuda")
    batch = torch.from_numpy(halton_jitters(TUNE_K)).cuda()
    fs0 = fk.FrameSettings(width=W, height=H)
    forms = {
        "which=0": (fs0, one, None),
        "which=1 aniso 4": (fs0._replace(which=1, env_aniso=4), one, None),
        "given rays": (fs0, None, fk.raygen_rays(uni, one, fs0)),
    }
    want = {f: fk.frame_kernel(packed, blk, jit, fs, rays=rays) for f, (fs, jit, rays) in forms.items()}
    small = fk.FrameSettings(width=TUNE_SMALL[0], height=TUNE_SMALL[1])
    small_row = fk.frame_kernel(packed, blk, one, small)[1]
    print(f"tune: the frame kernel's launch shapes on {card}")
    for tile_w, warp in FRAME_SHAPES:
        shape = dict(tile_w=tile_w, warp_map=warp)
        same = []
        for f, (fs, jit, rays) in forms.items():
            c, n = fk.frame_kernel(packed, blk, jit, fs._replace(**shape), rays=rays)
            same.append(torch.equal(bits(c), bits(want[f][0])) and torch.equal(n, want[f][1]))
        s = small._replace(**shape)
        rows = torch.full((s.n_tiles(), 1 + 3 * s.phases()), -1, dtype=torch.long, device="cuda")
        prow = torch.empty_like(rows)
        row = fk.frame_kernel(packed, blk, one, s, tile_rows=rows)[1]
        fk.frame_plain(packed, uni, one, s, tile_rows=prow)
        torch.cuda.synchronize()
        why = tile_rows_disagreement(rows.cpu(), prow.cpu())
        against = why or ("equal" if torch.equal(rows, prow) else "within the limit")
        print(f"  {tile_w}x{fk.BLOCK // tile_w} {warp}: colour and counter row bit for bit the "
              f"default's ({', '.join(forms)}): {same}; {TUNE_SMALL[0]}x{TUNE_SMALL[1]} rows "
              f"{tuple(rows.shape)} sum to the row {torch.equal(rows.sum(0), row)}, row the default's "
              f"{torch.equal(row, small_row)}, against frame_plain's: {against}")
        if not all(same) or not torch.equal(rows.sum(0), row) or not torch.equal(row, small_row) \
                or why is not None:
            raise AssertionError(f"tune: shape {tile_w} {warp} strays from the default launch")
    try:
        fk.frame_kernel(packed, blk, one, fs0._replace(tile_w=12))
    except RuntimeError as e:
        print(f"  tile_w=12 refused: {e}")
    else:
        raise AssertionError("tune: the kernel launched a 12-pixel tile")
    linear = RenderStatics(width=W, height=H, do_tonemap=False)
    failed_best, failed_res = autotune(renderer, linear, params, samples=1, frames=1, apply=False,
                                       space=[[{"frame_tile": 16}, {"frame_tile": 12}]])
    if len(failed_res) != 1 or failed_best != {"frame_tile": 16}:
        raise AssertionError(f"tune: a refused shape is no failed candidate: {failed_res}")

    # (b) each shape's time, in turns
    t1 = {sh: [] for sh in FRAME_SHAPES}
    t64 = {sh: [] for sh in FRAME_SHAPES}
    for _ in range(2):
        for sh in FRAME_SHAPES:
            fs = fs0._replace(tile_w=sh[0], warp_map=sh[1])
            t1[sh] += cuda_times(routed(packed, params, fs), TIMED // 2)
            t64[sh] += [t / TUNE_K for t in cuda_times(routed(packed, params, fs, batch), 5)]
    shapes = {}
    for sh in FRAME_SHAPES:
        info = fk.launch_info(packed.stack_depth, "bilinear", tile_w=sh[0], warp_map=sh[1])
        if (info["tile_w"], info["tile_h"]) != (sh[0], fk.BLOCK // sh[0]):
            raise AssertionError(f"tune: launch_info reports tile {info['tile_w']}x{info['tile_h']}")
        m1, m64 = float(np.median(t1[sh])), float(np.median(t64[sh]))
        shapes[f"{sh[0]}x{fk.BLOCK // sh[0]} {sh[1]}"] = {"k1_ms": round(m1, 4), "k64_ms": round(m64, 4)}
        base1, base64 = np.median(t1[FRAME_SHAPES[0]]), np.median(t64[FRAME_SHAPES[0]])
        print(f"  {sh[0]}x{fk.BLOCK // sh[0]} {sh[1]} on {card}: K=1 {summary(t1[sh])} "
              f"({m1 / base1 - 1:+.1%} against 16x16 rows); K={TUNE_K} a sample {summary(t64[sh])} "
              f"({m64 / base64 - 1:+.1%}); {info['registers']} registers, {info['local_bytes']} local "
              f"bytes, {info['blocks_per_sm']} blocks an SM")

    # (c) App.tune, then its cache hit; (d) the bench under BENCH_TUNE=1 and auto
    tmp = tempfile.mkdtemp()
    saved_cache = os.environ.get("SRT_CACHE_DIR")
    os.environ["SRT_CACHE_DIR"] = os.path.join(tmp, "cache")
    cfg_before = copy.copy(renderer.cfg)
    try:
        app = App(bench_world(), renderer, renderer.cfg, width=W, height=H)
        app.scene_key = "chip-smoke-bench69k"
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        best = app.tune(TUNE_K, file=sys.stdout)
        tune_s = time.perf_counter() - t0
        launched = dict(_build.LAUNCHES)
        print(f"tune path launches (App.tune({TUNE_K}) on bench69k, {tune_s:.1f} s): {launched}")
        if not best or launched.get("frame_kernel", 0) < 1 or set(launched) != {"frame_kernel"} \
                or (renderer.cfg.frame_tile, renderer.cfg.frame_warp) != (best["frame_tile"],
                                                                           best["frame_warp"]):
            raise AssertionError(f"tune: App.tune applied {best}, launches {launched}")
        _build.LAUNCHES.clear()
        again = app.tune(TUNE_K, file=sys.stdout)
        print(f"tune: second App.tune: {again}, launches {dict(_build.LAUNCHES)}")
        if again != best or _build.LAUNCHES:
            raise AssertionError("tune: the second App.tune is no cache hit")
        runs = []
        for mode in ("1", "auto"):
            env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
            env.update(PYTHONPATH=ROOT, BENCH_TUNE=mode, BENCH_EXTRAS="0", BENCH_OCCLUDED="0")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "shader_ray_tpu_torch.bench"],
                                  capture_output=True, text=True, timeout=600, env=env, cwd=tmp)
            secs = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            out = json.loads(lines[-1]) if lines else {}
            knobs = [s_ for s_ in proc.stderr.splitlines()
                     if s_.startswith(("autotune", "applying cached tune"))]
            print(f"tune: bench BENCH_TUNE={mode}: rc {proc.returncode} in {secs:.1f} s, frame_ms "
                  f"{out.get('frame_ms')}, single {out.get('frame_ms_single_dispatch')}; "
                  + "; ".join(knobs))
            runs.append((proc, out, secs))
            if proc.returncode != 0 or "golden gate: ok" not in proc.stderr or "error" in out:
                raise AssertionError(f"tune: bench BENCH_TUNE={mode} failed:\n{proc.stderr[-3000:]}")
        searched = next((s_ for s_ in runs[0][0].stderr.splitlines() if s_.startswith("autotune best: ")),
                        None)
        bench_best = searched and searched[len("autotune best: "):]
        if not bench_best or f"applying cached tune: {bench_best}" not in runs[1][0].stderr:
            raise AssertionError("tune: BENCH_TUNE=auto did not apply the BENCH_TUNE=1 winner")
    finally:
        renderer.cfg = cfg_before
        if saved_cache is None:
            os.environ.pop("SRT_CACHE_DIR", None)
        else:
            os.environ["SRT_CACHE_DIR"] = saved_cache
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    print(f"tune on {card}: App.tune({TUNE_K}) picked {best} in {tune_s:.1f} s; bench BENCH_TUNE=1 "
          f"picked {bench_best}: frame_ms {runs[0][1]['frame_ms']} (BENCH_TUNE=1), "
          f"{runs[1][1]['frame_ms']} (auto); phase {secs:.1f} s")
    return {"launches": launched, "best": best, "bench_best": bench_best, "shapes": shapes,
            "seconds": secs, "bench_frame_ms": [r[1]["frame_ms"] for r in runs]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from shader_ray_tpu_torch.engine import Renderer
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    import numpy as np

    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.models.fixtures import procedural_sky, uv_sphere
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.ops import env_kernel as ek
    from shader_ray_tpu_torch.ops import frame_kernel as fk
    from shader_ray_tpu_torch.ops import trace_kernel as tk
    from shader_ray_tpu_torch.ops.engine_frame import frame_jitter, halton_jitters, pack_uniforms
    from shader_ray_tpu_torch.ops.envmap import ANISO_PROBES
    from shader_ray_tpu_torch.ops.pack import pack_scene
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide
    from shader_ray_tpu_torch.ops.render import RenderStatics, generate_rays
    from shader_ray_tpu_torch.ops.vecmath import dot, normalize

    FAR = tk.INFINITELY_FAR

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"count {torch.cuda.device_count()}")

    # 2. build: one nvcc per source and g++ for the native scene builder,
    # all started together; the scenes build natively or the run fails
    os.environ["SRT_NATIVE"] = "require"  # the CLI runs below too
    import threading

    from shader_ray_tpu_torch import native

    g_build = {}

    def build_native():
        t = time.perf_counter()
        try:
            native.build()
        except RuntimeError as e:
            g_build["error"] = e
        g_build["s"] = time.perf_counter() - t

    t0 = time.perf_counter()
    g_thread = threading.Thread(target=build_native)
    g_thread.start()
    _build.build(KERNEL_SOURCES)
    t_nvcc = time.perf_counter() - t0
    g_thread.join()
    if "error" in g_build:
        raise g_build["error"]
    print(f"build: nvcc x{len(KERNEL_SOURCES)} in parallel {t_nvcc:.2f} s; g++ libscene beside "
          f"them {g_build['s']:.2f} s")
    for name in KERNEL_SOURCES:
        for line in _build.library(name)[1].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 3. scene: the bench configuration (bench.py:322-331), packed three
    # ways: wide tables for the fused and the unfused route, binary tables
    t0 = time.perf_counter()
    data, sky, params = bench_inputs()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    renderer = Renderer(data, sky)
    unfused = Renderer(data, sky, Config(packet_fused=False))
    binary = Renderer(data, sky, Config(packet_kernel="binary"))
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    packed, packed_b = renderer.packed, binary.packed
    pyramid = packed.env_pyramid
    print(f"scene: {data.triangle_count} triangles, {data.group_count} binary nodes, "
          f"{packed.n_wide} wide nodes, stack {packed.stack_depth}, "
          f"{pyramid.n_levels} env levels from {pyramid.base}; "
          f"build {t_build:.2f} s, 3 packs+uploads {t_pack:.2f} s")
    frame_info = {(mode, given): fk.launch_info(packed.stack_depth, mode, given)
                  for given in (False, True) for mode in fk.FRAME_MODES}
    for (mode, given), info in frame_info.items():
        print(f"frame_kernel launch, {mode}, {'given rays' if given else 'raygen'}, at stack "
              f"{packed.stack_depth}: {info['registers']} "
              f"registers, {info['local_bytes']} B local a thread, shared {info['static_smem']} B "
              f"static + {info['dynamic_smem']} B dynamic (stack{' and differentials' if mode != 'bilinear' else ''}) "
              f"a block, {info['threads']} threads a block ({info['tile_w']}x{info['tile_h']} tile), "
              f"{info['blocks_per_sm']} blocks an SM")
    for name in ("trace_wide", "trace_binary"):
        info = tk.launch_info(name, packed.stack_depth)
        print(f"{name} launch at stack {packed.stack_depth}: {info['registers']} registers, "
              f"{info['local_bytes']} B local a thread, shared {info['static_smem']} B static + "
              f"{info['dynamic_smem']} B stack a block, {info['threads']} threads a block, "
              f"{info['blocks_per_sm']} blocks an SM")
    for mode in ek.MODES:
        info = ek.launch_info(mode)
        print(f"env_sample launch, {mode}: {info['registers']} registers, "
              f"{info['local_bytes']} B local a thread, shared {info['static_smem']} B static, "
              f"{info['threads']} threads a block, {info['blocks_per_sm']} blocks an SM")
    params_cuda = type(params)(*[x.cuda() for x in params])
    uni = pack_uniforms(params).cuda()
    blk = block_of(uni)
    statics = RenderStatics(width=W, height=H)
    linear = statics._replace(do_tonemap=False)
    errs = dict.fromkeys(("frame_kernel", "trace_wide", "trace_binary", "env_sample",
                          "frame_kernel_mt", "trace_wide_mt"), 0.0)

    # 4. each kernel vs its plain version on the card
    def compare(w: int, h: int, jit: torch.Tensor | None, probe: dict | None = None,
                which: int = 0, aniso: int = 1, tables=None, view=None):
        """The frame kernel against frame_plain on the bench tables (or
        ``tables``, whose leaf form names the kernel).  With a ``view``
        (FrameParams; ``jit`` None) the kernel launches as a frame function
        launches it (``routed``: a new host block, the uniforms and the
        view's jitter by value) and frame_plain takes the uploaded table and
        a (1, 2) jitter table."""
        tables = tables or packed
        name = tk.launch_name("frame_kernel", tables.isect)
        fs = fk.FrameSettings(width=w, height=h, which=which, env_aniso=aniso)
        if view is None:
            kc, kn = fk.frame_kernel(tables, blk, jit, fs)
            p_uni = uni
        else:
            kc, kn = routed(tables, view, fs)()
            p_uni, jit = pack_uniforms(view).cuda(), frame_jitter(view).cuda()
            name += " (routed, by value)"
        k = jit.shape[0]
        pc, pn = fk.frame_plain(tables, p_uni, jit, fs, probe)
        torch.cuda.synchronize()
        diff = (kc - pc).abs()
        key = tk.launch_name("frame_kernel", tables.isect)
        errs[key] = max(errs[key], float(diff.nan_to_num(0.0).max()))
        kn, pn = kn.cpu(), pn.cpu()
        cast_rel = abs(int(kn[0]) - int(pn[0])) / max(int(pn[0]), 1)
        excess, i = walk_counter_excess(kn, pn)
        print(f"{name} vs plain {w}x{h} K={k} which={which} aniso={aniso}: max abs "
              f"{float(diff.max()):.3e}, mean abs {float(diff.mean()):.3e}; cast {int(kn[0])} vs "
              f"{int(pn[0])} (rel {cast_rel:.2e}); walk counters: worst {int(kn[i])} vs "
              f"{int(pn[i])} (counter {i}), {excess:.3f} of its limit")
        why = frame_disagreement(kc, kn, pc, pn)
        if why:
            raise AssertionError(f"{name} disagrees with frame_plain at {w}x{h} K={k} "
                                 f"which={which} aniso={aniso}: {why}")

    def compare_small(tables=None):
        """compare() at SMALL: K = 1 and 4 at which = 0, K = 2 in the grad modes."""
        compare(*SMALL, torch.from_numpy(halton_jitters(1)).cuda(), tables=tables)
        compare(*SMALL, torch.from_numpy(halton_jitters(4)).cuda(), tables=tables)
        for which, aniso in ((1, 1), (1, 4), (2, 1)):
            compare(*SMALL, torch.from_numpy(halton_jitters(2)).cuda(), which=which, aniso=aniso,
                    tables=tables)

    red = torch.tensor([1.0, 0.0, 0.0], device="cuda")

    def frame_case_check(name, kname, c_packed, c_uni, c_jit, c_fs, c_rays, isect):
        """Kernel ``kname`` against frame_plain on FRAME_CASES' case ``name``."""
        kc, kn = fk.frame_kernel(c_packed, block_of(c_uni), c_jit, c_fs, rays=c_rays)
        pc, pn = fk.frame_plain(c_packed, c_uni, c_jit, c_fs, rays=c_rays)
        torch.cuda.synchronize()
        painted = int((kc == red).all(-1).sum()), int((pc == red).all(-1).sum())
        print(f"{kname} vs plain, case {name} ({c_fs.width}x{c_fs.height} "
              f"K={CASE_SAMPLES.get(name, 1)}{', given rays' if c_rays else ''}, "
              f"{c_fs.bounce_count} bounces, shadows {c_fs.cast_shadows}, diffuse "
              f"{c_fs.enable_diffuse}, which {c_fs.which}, aniso {c_fs.env_aniso}, min_contrib "
              f"{c_fs.min_contrib}): NaN pixels "
              f"{int(torch.isnan(kc).any(-1).sum())} vs {int(torch.isnan(pc).any(-1).sum())}, "
              f"mean abs {float((kc - pc).abs().nanmean()):.3e}, cast "
              f"{int(kn[0])} vs {int(pn[0])}, walk counters {kn[1:].sum().item()} vs "
              f"{pn[1:].sum().item()} (worst {walk_counter_excess(kn.cpu(), pn.cpu())[0]:.3f} "
              f"of its limit), bad-painted pixels {painted[0]} vs {painted[1]}")
        why = frame_disagreement(kc, kn.cpu(), pc, pn.cpu()) or \
            case_unmet(name, c_fs, pc, pn.cpu(), isect)
        if why or abs(painted[0] - painted[1]) > max(1e-4 * kc[..., 0].numel(), 1):
            raise AssertionError(f"{kname} disagrees with frame_plain on case {name}: {why}")
        if c_fs.min_contrib >= 1.0:
            # every hit lane retires after bounce 0: the kernel's own
            # one-bounce frame, bit for bit, and no later walk
            oc, on = fk.frame_kernel(c_packed, block_of(c_uni), c_jit, c_fs._replace(bounce_count=1))
            same = torch.equal(kc, oc) and torch.equal(kn[:on.numel()], on) and \
                not kn[on.numel():].any()
            print(f"  case {name}: the kernel's frame equals its bounce_count=1 frame bit for bit, "
                  f"colour and counters: {same}")
            if not same:
                raise AssertionError(f"case {name}: not the kernel's bounce_count=1 frame")

    def frame_cases(isect: str = "woop"):
        """The frame kernel against frame_plain on each of FRAME_CASES, the
        cases' tables of leaf form ``isect``."""
        kname = tk.launch_name("frame_kernel", isect)
        for name in FRAME_CASES:
            frame_case_check(name, kname, *frame_case(name, torch.device("cuda"), isect), isect)

    compare_small()
    # a frame function's launch at the bench shape, its jitter by value
    view = params._replace(pixel_jitter=torch.tensor([0.25, -0.375]))
    compare(W, H, None, view=view)
    compare(W, H, None, which=1, aniso=4, view=view)
    frame_cases()

    def rays_at(w: int, h: int):
        """Object-space primary rays of the bench camera (the object
        matrices are the identity) and one bounce's shadow rays: from
        each light-facing closest hit, fudged off the surface, toward
        the light."""
        rays = generate_rays(RenderStatics(width=w, height=h), params_cuda)
        P, D = rays.P.contiguous(), rays.D.contiguous()
        hit = tk.trace_wide(packed, P, D)
        n = normalize(hit.normal)
        n = torch.where((dot(n, D) > 0.0)[:, None], -n, n)
        L = params_cuda.light_dir
        sact = (hit.t < FAR) & ~hit.bad & (dot(n, L) > 0.0)
        sP = (P + hit.t[:, None] * D + n * 1e-4).contiguous()
        sP = torch.where(sact[:, None], sP, P)
        return rays, P, D, sP, L.expand_as(P).contiguous(), sact

    def compare_trace(name, kernel, plain, tables, P, D, active, any_hit, what, width=0):
        """The kernel against its plain version on the same rays (an
        image of that width, or a list), under trace_disagreement's
        limits.  Returns the plain walk's result and its device time (one
        call)."""
        got = kernel(tables, P, D, active, any_hit=any_hit, with_stats=True, width=width)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        walk = plain(tables, P, D, active, any_hit)
        want = tk.packet_hit(walk, True)
        stop.record()
        torch.cuda.synchronize()
        e, why = trace_disagreement(got, want, active, any_hit)
        errs[name] = max(errs[name], e["t_max"], e["n_max"])
        print(f"{name} vs plain, {what} ({P.shape[0]} rays, {int(active.sum())} active, "
              f"{int((got.t < FAR).sum())} hit): t mean abs {e['t_mean']:.3e} (limit 1e-5), max abs "
              f"{e['t_max']:.3e}, rays off by > 1e-4 {e['t_off']:.2e} (limit 1e-4), hit flips "
              f"{e['flips']:.2e} (limit 1e-3), id mismatches outside ties {e['ids']:.2e} (limit "
              f"1e-4), bad equal {e['bad_equal']}, walk counters max rel diff {e['stats_rel']:.2e} "
              f"(limit 1e-3)"
              + ("" if any_hit else f", normal mean abs {e['n_mean']:.3e} (limit 1e-5), max abs "
                 f"{e['n_max']:.3e}"))
        if why:
            raise AssertionError(f"{name} disagrees with its plain version on {what}: {why}")
        return walk, start.elapsed_time(stop)

    def compare_env(D, gx, gy, grad, aniso, what, nan_rays=None):
        """The kernel against its plain version under env_disagreement's
        limits; ``nan_rays``: the rays that must be NaN in both."""
        got = ek.env_sample(pyramid, D, gx, gy, grad=grad, aniso=aniso)
        want = ek.env_sample_plain(pyramid, D, gx, gy, grad=grad, aniso=aniso)
        torch.cuda.synchronize()
        e, why = env_disagreement(got, want, nan_rays)
        errs["env_sample"] = max(errs["env_sample"], e["max"])
        print(f"env_sample vs plain, {what} ({D.shape[0]} rays): max abs {e['max']:.3e} "
              f"(limit 1e-2), mean abs {e['mean']:.3e} (limit 1e-5), NaN rays {e['nan_rays']} "
              f"(expected {0 if nan_rays is None else int(nan_rays.sum())})")
        if why:
            raise AssertionError(f"env_sample disagrees with its plain version on {what}: {why}")

    def env_needs(D, gx, gy, grad, aniso) -> tuple[int, int]:
        """What the lookup of these rays needs, as the plain version
        counts it: the bilinear fetches made at a non-zero weight, and
        the bytes of the distinct pyramid texels they read (12 a texel,
        whatever the layout)."""
        touched = torch.zeros(pyramid.texels.shape[0], dtype=torch.bool, device="cuda")
        fetches = torch.zeros((), dtype=torch.long, device="cuda")
        ek.env_sample_plain(pyramid, D, gx, gy, grad=grad, aniso=aniso, touched=touched,
                            fetches=fetches)
        return int(touched.sum()) * 12, int(fetches)

    def on_a_level(R, aniso, fetches) -> str:
        """The share of a grad lookup's probes whose lod lies exactly on
        a level (one fetch, the upper level's weight 0), from the plain
        version's fetch count."""
        probes = R * (ANISO_PROBES if aniso > 1 else 1)
        return f"{2 * probes - fetches} of {probes} probes ({(2 * probes - fetches) / probes:.4f})"

    rays_s, P_s, D_s, sP_s, sD_s, sact_s = rays_at(*SMALL)
    all_s = torch.ones_like(sact_s)
    size = f"{SMALL[0]}x{SMALL[1]}"
    spos, snrm = uv_sphere(lat=64, lon=128)
    sdata = get_shader_data(make_world(TriangleSet.from_arrays(spos, snrm)))

    def trace_checks(kernels):
        """Each (name, kernel, plain version, bench tables, smooth-sphere
        tables) of ``kernels`` against its plain version at SMALL: closest
        and any-hit on the primaries and the shadow rays; the masks' and
        layouts' edges (TRACE_CASES) on the same primaries, each case's
        plain walks showing its path; and the closest hits on a smooth
        unit sphere, since the bench scene is flat-shaded (one normal a
        triangle) and the normal interpolation shows only there."""
        for name, kernel, plain, tables, _ in kernels:
            for what, Pr, Dr, act in (("primaries", P_s, D_s, all_s),
                                      ("shadow rays", sP_s, sD_s, sact_s)):
                for any_hit in (False, True):
                    compare_trace(name, kernel, plain, tables, Pr, Dr, act, any_hit,
                                  f"{'any-hit' if any_hit else 'closest'}, {what} {size}",
                                  SMALL[0])
        for case in TRACE_CASES:
            cP, cD, cact, cw = trace_case(case, P_s, D_s)
            for name, kernel, plain, tables, _ in kernels:
                for any_hit in (False, True):
                    walk, _ = compare_trace(name, kernel, plain, tables, cP, cD, cact, any_hit,
                                            f"{'any-hit' if any_hit else 'closest'}, case {case}",
                                            cw)
                    why = trace_case_unmet(case, cact, walk.steps)
                    if why:
                        raise AssertionError(f"{name}: {why}")
        for name, kernel, plain, _, smooth in kernels:
            walk, _ = compare_trace(name, kernel, plain, smooth, P_s, D_s, all_s, False,
                                    f"closest, smooth sphere, primaries {size}", SMALL[0])
            inside = (walk.t < FAR) & ((walk.normal.norm(dim=1) - 1.0).abs() > 1e-4)
            if int(inside.sum()) < 1000:
                raise AssertionError(f"{name}: the smooth sphere gave no interpolated normals "
                                     "to compare")

    trace_checks((
        ("trace_wide", tk.trace_wide, tk.walk_plain, packed,
         pack_scene_wide(sdata, procedural_sky(32)).to("cuda")),
        ("trace_binary", tk.trace_binary, tk.walk_binary_plain, packed_b,
         pack_scene(sdata, procedural_sky(32)).to("cuda")),
    ))
    # primaries with their differentials, plus seeded directions over the
    # whole sphere (seam and poles included) with wide footprints
    rng = np.random.default_rng(7)
    n_s = P_s.shape[0]
    Dr = rng.normal(size=(n_s, 3)).astype(np.float32)
    Dr /= np.linalg.norm(Dr, axis=1, keepdims=True)
    gr = rng.normal(size=(2, n_s, 3)).astype(np.float32) * \
        (10.0 ** rng.uniform(-4.0, -1.0, size=(1, n_s, 1))).astype(np.float32)
    D_e = torch.cat([D_s, torch.from_numpy(Dr).cuda()]).contiguous()
    gx_e = torch.cat([rays_s.dDdx, torch.from_numpy(gr[0]).cuda()]).contiguous()
    gy_e = torch.cat([rays_s.dDdy, torch.from_numpy(gr[1] * 0.3).cuda()]).contiguous()
    compare_env(D_e, None, None, False, 1, "mode 0")
    compare_env(D_e, gx_e, gy_e, True, 1, "grad, aniso=1")
    compare_env(D_e, gx_e, gy_e, True, 4, "grad, aniso=4")
    # directions exactly along +-y: in grad mode 0/0 in du/dx, NaN radiance
    # as the reference gives; mode 0 stays finite there
    D_p, gx_p, gy_p, axis = pole_rays(4096, "cuda")
    compare_env(D_p, None, None, False, 1, "mode 0, a quarter of the rays along +-y")
    for aniso in (1, 4):
        compare_env(D_p, gx_p, gy_p, True, aniso, f"grad, aniso={aniso}, a quarter of the rays "
                    f"along +-y", nan_rays=axis)

    # 5-6. the fused path through the Renderer's entry points
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    img = renderer.make_fn(statics)(params)
    torch.cuda.synchronize()
    print(f"fused path: make_fn {W}x{H} first frame {time.perf_counter() - t0:.3f} s")
    golden_gate(img.cpu().numpy(), GOLDEN, "fused which=0")

    prog = renderer.make_progressive_fn(linear, PROG_K)(params)
    single = renderer.make_fn(linear)
    fused_linear = single(params)  # the unfused frames below are held to it
    jitters = halton_jitters(PROG_K)
    total = None
    for s in range(PROG_K):
        f = single(params._replace(pixel_jitter=torch.from_numpy(jitters[s])))
        total = f if total is None else total + f
    mean = total / PROG_K
    rel = float(((prog - mean).abs() / mean.abs().clamp_min(1e-6)).max())
    print(f"progressive K={PROG_K}: max rel diff vs mean of {PROG_K} frames {rel:.3e} (limit 1e-5)")
    if rel > 1e-5:
        raise AssertionError("progressive mean disagrees with its frames")
    cast = renderer.make_count_fn(statics)(params)
    print(f"count: {cast} rays cast of {W * H * 6} potential")
    if not W * H <= cast <= W * H * 6:
        raise AssertionError(f"cast count {cast} outside [W*H, 6*W*H]")

    # the grad-env modes on the same route: one frame-kernel launch a
    # frame, no trace and no env launch; held to the unfused route below
    fused_grad = {}
    for which, aniso in GRAD_MODES:
        before = dict(_build.LAUNCHES)
        f = renderer.make_fn(linear._replace(which=which, env_aniso=aniso))(params)
        torch.cuda.synchronize()
        added = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items() if n != before.get(k, 0)}
        print(f"fused path: make_fn {W}x{H} which={which} aniso={aniso}: launches {added}, "
              f"shape {tuple(f.shape)}, finite {bool(torch.isfinite(f).all())}, "
              f"mean {float(f.mean()):.4f}")
        if added != {"frame_kernel": 1} or tuple(f.shape) != (H, W, 3) or not torch.isfinite(f).all():
            raise AssertionError(f"fused which={which}: one frame_kernel launch and a finite frame")
        fused_grad[which] = f
    grad1 = linear._replace(which=1, env_aniso=4)
    prog1 = renderer.make_progressive_fn(grad1, 4)(params)
    mean1 = sum(renderer.make_fn(grad1)(params._replace(pixel_jitter=torch.from_numpy(j)))
                for j in halton_jitters(4)) / 4
    rel1 = float(((prog1 - mean1).abs() / mean1.abs().clamp_min(1e-6)).max())
    cast1 = renderer.make_count_fn(grad1)(params)
    print(f"progressive which=1 aniso=4 K=4: max rel diff vs mean of 4 frames {rel1:.3e} "
          f"(limit 1e-5); count at which=1 {cast1} (which=0: {cast})")
    if rel1 > 1e-5 or cast1 != cast:
        raise AssertionError("fused which=1: progressive or count disagrees")

    # the stats fn: a which=0 frame's counter row per 16x16 tile
    rows = renderer.make_stats_fn(statics)(params)
    fs0 = fk.FrameSettings(width=W, height=H)
    frame_row = fk.frame_kernel(packed, blk, torch.zeros((1, 2), device="cuda"), fs0)[1]
    torch.cuda.synchronize()
    phases = fk.stats_phases(statics.bounce_count, statics.cast_shadows, statics.enable_diffuse)
    print(f"stats fn: rows {tuple(rows.shape)} ({fs0.n_tiles()} tiles x 1 + 3 x {len(phases)} "
          f"phases); column sums equal the frame's row: {bool(torch.equal(rows.sum(0), frame_row))}; "
          f"rays cast {int(rows[:, 0].sum())} (make_count_fn {cast})")
    for p, name in enumerate(phases):
        pops = rows[:, 1 + 3 * p].double()
        print(f"  {name}: node pops a tile mean {float(pops.mean()):.1f} (max {int(pops.max())}), "
              f"leaf visits {float(rows[:, 2 + 3 * p].double().mean()):.1f}, triangle tests "
              f"{float(rows[:, 3 + 3 * p].double().mean()):.1f}")
    if (tuple(rows.shape) != (fs0.n_tiles(), 1 + 3 * len(phases))
            or not torch.equal(rows.sum(0), frame_row) or int(rows[:, 0].sum()) != cast):
        raise AssertionError("stats fn rows disagree with the frame's counter row or the count")

    # which=5 on the same route: ONE frame_kernel launch of its given-rays
    # form over the 25 sub-ray sets of the primaries
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    img5_f = renderer.make_fn(statics._replace(which=5))(params)
    torch.cuda.synchronize()
    added = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items() if n != before.get(k, 0)}
    print(f"fused path: make_fn {W}x{H} which=5: launches {added}, first frame "
          f"{time.perf_counter() - t0:.3f} s")
    if added != {"frame_kernel": 1}:
        raise AssertionError("fused which=5: one frame_kernel launch a frame")
    golden_gate(img5_f.cpu().numpy(), GOLDEN5, "fused which=5")
    lin5_f = renderer.make_fn(linear._replace(which=5))(params)  # held to the unfused route below
    cast5 = renderer.make_count_fn(statics._replace(which=5))(params)
    print(f"count at which=5: {cast5} (which=0: {cast})")
    if cast5 != cast:
        raise AssertionError("fused which=5 counts another frame than which=0's")

    # lane retirement through the Renderer's entry points: Config.min_contrib
    # is read at each call
    renderer.cfg.min_contrib = 0.004
    try:
        lin_mc = renderer.make_fn(linear)(params)
        cast_mc = renderer.make_count_fn(statics)(params)
    finally:
        renderer.cfg.min_contrib = 0.0
    err_mc = float((lin_mc - fused_linear).abs().max())
    print(f"fused path, min_contrib=0.004: rays cast {cast_mc} of {cast} ({cast_mc / cast - 1:+.2%}); "
          f"linear colour vs min_contrib=0: max abs {err_mc:.3e} (limit 3 x 0.004 x the env's "
          f"largest radiance {float(pyramid.texels.max()):.2f}), mean abs "
          f"{float((lin_mc - fused_linear).abs().mean()):.3e}")
    if not cast_mc < cast or err_mc > 3 * 0.004 * float(pyramid.texels.max()):
        raise AssertionError("min_contrib=0.004 retired no lane or strayed beyond its bound")
    torch.cuda.synchronize()
    launches = {"frame_kernel": _build.LAUNCHES["frame_kernel"]}
    print(f"fused path launches: {dict(_build.LAUNCHES)}")
    if launches["frame_kernel"] < 1 or len(_build.LAUNCHES) != 1:
        raise AssertionError("the fused path must launch frame_kernel and nothing else")

    # 6b. the unfused path through the Renderer's entry points
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    wide_linear = unfused.make_fn(linear)(params)
    torch.cuda.synchronize()
    print(f"unfused path: make_fn {W}x{H} which=0, wide tables, first frame "
          f"{time.perf_counter() - t0:.3f} s")
    diff = float((wide_linear - fused_linear).abs().mean())
    cast_u = unfused.make_count_fn(statics)(params)
    cast_rel = abs(cast_u - cast) / cast
    print(f"unfused vs fused frame: mean abs {diff:.3e} on linear colour (limit 1e-5); "
          f"cast {cast_u} vs {cast} (rel {cast_rel:.2e}, limit 1e-5)")
    if diff > 1e-5 or cast_rel > 1e-5:
        raise AssertionError("the unfused frame disagrees with the fused frame")
    golden_gate(unfused.make_fn(statics)(params).cpu().numpy(), GOLDEN, "unfused which=0")

    t0 = time.perf_counter()
    img5 = unfused.make_fn(statics._replace(which=5))(params)
    torch.cuda.synchronize()
    t_which5 = time.perf_counter() - t0
    print(f"unfused path: which=5 (25 sub-frames) {t_which5:.3f} s")
    golden_gate(img5.cpu().numpy(), GOLDEN5, "unfused which=5")
    lin5_u = unfused.make_fn(linear._replace(which=5))(params)
    diff5 = float((lin5_f - lin5_u).abs().mean())
    print(f"fused vs unfused which=5: mean abs {diff5:.3e} on linear colour (limit 1e-5)")
    if diff5 > 1e-5:
        raise AssertionError("the fused which=5 frame disagrees with the unfused one")

    frames = {0: unfused.make_fn(statics)(params)}
    for which in (1, 2, 3):
        frames[which] = unfused.make_fn(statics._replace(which=which, env_aniso=4))(params)
        f = frames[which]
        if tuple(f.shape) != (H, W, 3) or not torch.isfinite(f).all():
            raise AssertionError(f"which={which}: shape {tuple(f.shape)} or non-finite pixels")
        print(f"unfused path: which={which} finite, shape {tuple(f.shape)}, mean {float(f.mean()):.4f}")
    d1 = (frames[1] - frames[0]).abs()
    print(f"which=1 (env_aniso=4) vs which=0, tonemapped: mean abs {float(d1.mean()):.3e} "
          f"(limit 1e-2), pixels off by > 0.05: {float((d1.amax(dim=-1) > 0.05).float().mean()):.4%}")
    if float(d1.mean()) > 1e-2:
        raise AssertionError("which=1 strays from which=0 beyond a filtered env's difference")
    if float((frames[2] - frames[0]).abs().mean()) < 1e-3 or float(frames[3].std()) < 1e-4:
        raise AssertionError("which=2/3 did not render their visualisation")

    t0 = time.perf_counter()
    bin_linear = binary.make_fn(linear)(params)
    torch.cuda.synchronize()
    print(f"unfused path: make_fn {W}x{H} which=0, binary tables, first frame "
          f"{time.perf_counter() - t0:.3f} s")
    diff_b = float((bin_linear - wide_linear).abs().mean())
    cast_b = binary.make_count_fn(statics)(params)
    print(f"binary vs wide unfused frame: mean abs {diff_b:.3e} on linear colour (limit 1e-4); "
          f"cast {cast_b} vs {cast_u}")
    if diff_b > 1e-4 or abs(cast_b - cast_u) > 1e-4 * cast_u:
        raise AssertionError("the binary-table frame disagrees with the wide-table frame")
    golden_gate(binary.make_fn(statics)(params).cpu().numpy(), GOLDEN, "binary which=0")
    torch.cuda.synchronize()
    for name in ("trace_wide", "trace_binary", "env_sample"):
        launches[name] = _build.LAUNCHES[name]
    print(f"unfused path launches: {dict(_build.LAUNCHES)}")
    if min(launches.values()) < 1 or _build.LAUNCHES["frame_kernel"] != 0:
        raise AssertionError("the unfused path must launch trace_wide, trace_binary and "
                             "env_sample, and never frame_kernel")
    # the fused grad-mode frames against the unfused route's (the same
    # walk; FMA contraction in raygen, shading and the lookup): mean abs
    # <= 1e-5 of the frame's mean magnitude (at least 1)
    for which, aniso in GRAD_MODES:
        u = unfused.make_fn(linear._replace(which=which, env_aniso=aniso))(params)
        scale = max(1.0, float(u.abs().mean()))
        diff = float((fused_grad[which] - u).abs().mean())
        print(f"fused vs unfused which={which} aniso={aniso}: mean abs {diff:.3e} on linear colour "
              f"(limit {1e-5 * scale:.3e})")
        if not torch.isfinite(u).all() or diff > 1e-5 * scale:
            raise AssertionError(f"the fused which={which} frame disagrees with the unfused one")

    # 6c. the app: the REPL over an App on the bench scene at W x H, and
    # the CLI as a subprocess
    app_b = app_phase(renderer, card)

    # 7. timing at the main paths' shapes
    print(f"timing on {card}:")
    fs = fk.FrameSettings(width=W, height=H)
    one = torch.zeros((1, 2), dtype=torch.float32, device="cuda")
    batch = torch.from_numpy(halton_jitters(BATCH_K)).cuda()
    kernel_t = cuda_times(routed(packed, params, fs), TIMED)
    ms = float(np.median(kernel_t))
    batch_t = [t / BATCH_K for t in cuda_times(routed(packed, params, fs, batch), 5)]
    plain_t = cuda_times(lambda: fk.frame_plain(packed, uni, one, fs), 2)
    frame = renderer.make_fn(statics)
    e2e_t = host_times(lambda: frame(params), TIMED)
    e2e_ms = float(np.median(e2e_t))
    probe = {}
    compare(W, H, one, probe)  # the main path's frame: its counted work gives the bound
    ops, work = walk_ops(probe["walks"], 0, OPS_WOOP)
    wide_tables = nbytes(packed.nodes, packed.leaves, packed.normals)
    moved = wide_tables + env_needs(probe["env_D"], None, None, False, 1)[0] + nbytes(uni) + W * H * 3 * 4
    del probe
    bound_ms, bound_by = bound(ops, moved)
    potential = W * H * 6
    ms_batch = float(np.median(batch_t))
    print(f"  frame_kernel {W}x{H} K=1 (CUDA events): {summary(kernel_t)}; "
          f"{potential / ms / 1e3:.1f} Mrays/s potential, {cast / ms / 1e3:.1f} Mrays/s cast")
    print(f"  make_fn {W}x{H} fused, end to end (host clock, synchronized per frame): "
          f"{summary(e2e_t)}; kernel median {ms / e2e_ms:.1%} of it")
    print(f"  frame_kernel {W}x{H} K={BATCH_K}: per sample {summary(batch_t)}; "
          f"{potential / ms_batch / 1e3:.1f} Mrays/s potential")
    print(f"  frame_plain {W}x{H} K=1: {summary(plain_t)}")
    print(f"  bound: {work} -> {ops:.4g} ops "
          f"({ops / PEAK_F32 * 1e3:.4f} ms), {moved} bytes "
          f"({moved / PEAK_BYTES * 1e3:.4f} ms): {bound_ms:.4f} ms, by {bound_by}; "
          f"{bound_ms / ms:.2%} of the kernel's median")

    # A/B: the same frame's six walks as six separate trace_wide launches
    # (the unfused engine's calls, recorded from one frame and replayed)
    from shader_ray_tpu_torch.ops import engine_trace

    recorded = []

    def record(tables, P, D, active, **kw):
        recorded.append((P, D, active, kw))
        return tk.trace(tables, P, D, active, **kw)

    engine_trace.trace = record
    try:
        unfused.make_fn(statics)(params)
    finally:
        engine_trace.trace = tk.trace
    torch.cuda.synchronize()

    def six_walks():
        for P, D, active, kw in recorded:
            tk.trace_wide(unfused.packed, P, D, active, **kw)

    ab = {"fused": [], "walks": []}
    fns = {"fused": routed(packed, params, fs), "walks": six_walks}
    for which in ("fused", "walks", "walks", "fused"):  # in turns on one card
        ab[which] += cuda_times(fns[which], TIMED // 2)
    print(f"  A/B on {card}: frame_kernel {W}x{H} K=1 {summary(ab['fused'])}; the same "
          f"frame's {len(recorded)} walks as separate trace_wide launches (rays cast "
          f"{sum(int(a.sum()) for _, _, a, _ in recorded)}) {summary(ab['walks'])}")

    # the grad-mode instantiations on the bench frame: kernel, plain
    # version, make_fn end to end, and the bound with the env term's work
    # (which=1: the lookup's fetches at a non-zero weight and the distinct
    # texels they read, counted by the plain version on the env call's
    # rays; which=2: derivative math, no texel)
    grad_entry, grad_e2e = {}, {}
    for which, aniso in GRAD_MODES:
        fsg = fk.FrameSettings(width=W, height=H, which=which, env_aniso=aniso)
        t_k = cuda_times(routed(packed, params, fsg), TIMED)
        t_p = cuda_times(lambda: fk.frame_plain(packed, uni, one, fsg), 2)
        frame_g = renderer.make_fn(statics._replace(which=which, env_aniso=aniso))
        grad_e2e[which] = host_times(lambda: frame_g(params), TIMED)
        probe = {}
        compare(W, H, one, probe, which, aniso)
        g_ops, work = walk_ops(probe["walks"], 0, OPS_WOOP)
        n_env = probe["env_D"].shape[0]
        if which == 1:
            texels, fetches = env_needs(probe["env_D"], probe["env_dDdx"], probe["env_dDdy"], True,
                                        aniso)
            g_ops += n_env * (OPS_ENV_COORDS + OPS_ENV_GRAD) + fetches * OPS_PER_FETCH
        else:
            texels, fetches = 0, 0
            g_ops += n_env * OPS_ENV_GRAD
        g_moved = wide_tables + texels + nbytes(uni) + W * H * 3 * 4
        del probe
        g_ms = float(np.median(t_k))
        g_b_ms, g_b_by = bound(g_ops, g_moved)
        info = frame_info[fsg.mode(), False]
        print(f"  frame_kernel {W}x{H} K=1 which={which} aniso={aniso} ({fsg.mode()}; "
              f"{info['registers']} registers, {info['blocks_per_sm']} blocks an SM), CUDA events: "
              f"{summary(t_k)}; make_fn end to end (host clock): {summary(grad_e2e[which])}; "
              f"frame_plain {summary(t_p)}; bound: {work}, {fetches} env fetches -> "
              f"{g_ops:.4g} ops ({g_ops / PEAK_F32 * 1e3:.4f} ms), {g_moved} bytes of which "
              f"{texels} of distinct texels ({g_moved / PEAK_BYTES * 1e3:.4f} ms): {g_b_ms:.4f} ms, "
              f"by {g_b_by}; {g_b_ms / g_ms:.2%} of the kernel's median")
        key = f"which{which}" + (f"_aniso{aniso}" if which == 1 else "")
        grad_entry.update({f"{key}_ms": g_ms, f"{key}_plain_ms": float(np.median(t_p)),
                           f"{key}_bound_ms": g_b_ms, f"{key}_bound_by": g_b_by,
                           f"{key}_registers": info["registers"]})
    # the given-rays form on the bench frame: the fused which=5 frame (25
    # sets, one launch), its plain version set by set, its bound (25 x the
    # walks' counted work and the env fetches of each set, the rays read
    # once), make_fn by host clock beside the unfused which=5 frame's
    from shader_ray_tpu_torch.ops.engine_frame import primary_rays, supersample_directions

    def sets5():
        rays_p, (right, up) = primary_rays(statics, params_cuda)
        return fk.GivenRays(rays_p.P.contiguous(), supersample_directions(rays_p.D, right, up))

    t5_sets = cuda_times(sets5, 10)
    given5 = sets5()
    t5_k = cuda_times(routed(packed, params, fs, rays=given5), 20)
    k5, n5 = fk.frame_kernel(packed, blk, None, fs, rays=given5)
    ops5, moved5, t5_p, pops5 = 0, nbytes(given5.P, given5.D, uni) + W * H * 3 * 4 + wide_tables, 0.0, 0
    sum5 = torch.zeros((H, W, 3), device="cuda")
    touched5 = torch.zeros(pyramid.texels.shape[0], dtype=torch.bool, device="cuda")
    for k in range(given5.D.shape[0]):
        probe = {}
        one_set = fk.GivenRays(given5.P, given5.D[k:k + 1])
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        c_k, _ = fk.frame_plain(packed, uni, None, fs, probe, rays=one_set)
        stop.record()
        torch.cuda.synchronize()
        t5_p += start.elapsed_time(stop)
        sum5 += c_k
        o, _ = walk_ops(probe["walks"], 0, OPS_WOOP)
        fetches = torch.zeros((), dtype=torch.long, device="cuda")
        ek.env_sample_plain(pyramid, probe["env_D"], touched=touched5, fetches=fetches)
        ops5 += o + probe["env_D"].shape[0] * OPS_ENV_COORDS + int(fetches) * OPS_PER_FETCH
        pops5 += sum(int(w.steps.sum()) for w in probe["walks"])
        del probe
    moved5 += int(touched5.sum()) * 12
    err5 = float((k5 - sum5 / given5.D.shape[0]).abs().mean())
    b5_ms, b5_by = bound(ops5, moved5)
    ms5 = float(np.median(t5_k))
    frame5 = renderer.make_fn(statics._replace(which=5))
    e2e5 = host_times(lambda: frame5(params), 10)
    frame5_u = unfused.make_fn(statics._replace(which=5))
    e2e5_u = host_times(lambda: frame5_u(params), 3)
    info5 = frame_info["bilinear", True]
    print(f"  frame_kernel {W}x{H} which=5, given rays K=25 (one launch; {info5['registers']} "
          f"registers, {info5['blocks_per_sm']} blocks an SM), CUDA events: {summary(t5_k)}; rays "
          f"cast {int(n5[0])}, node pops {int(n5[1::3].sum())} (plain {pops5}); vs the plain sets' "
          f"mean: mean abs {err5:.3e}; frame_plain, 25 sets one by one: {t5_p:.1f} ms; bound: "
          f"{ops5:.4g} ops ({ops5 / PEAK_F32 * 1e3:.4f} ms), {moved5} bytes ({moved5 / PEAK_BYTES * 1e3:.4f} "
          f"ms): {b5_ms:.4f} ms, by {b5_by}; {b5_ms / ms5:.2%} of the kernel's median")
    print(f"  make_fn {W}x{H} which=5 end to end (host clock, synchronized per frame) on {card}: fused "
          f"{summary(e2e5)}, of which building the 25 direction sets {summary(t5_sets)} (CUDA "
          f"events); unfused wide {summary(e2e5_u)}")
    if err5 > 1e-4:
        raise AssertionError("frame_kernel which=5 disagrees with its plain sets")

    # lane retirement on the bench frame: min_contrib = 0.004
    fs_mc = fs._replace(min_contrib=0.004)
    t_mc = cuda_times(routed(packed, params, fs_mc), TIMED)
    c_mc, n_mc = fk.frame_kernel(packed, blk, one, fs_mc)
    n0 = fk.frame_kernel(packed, blk, one, fs)[1]
    phases_n = fk.stats_phases(3, True, True)
    print(f"  frame_kernel {W}x{H} K=1 min_contrib=0.004 (CUDA events): {summary(t_mc)} (0: "
          f"{summary(kernel_t)}); rays cast {int(n_mc[0])} (0: {int(n0[0])}); node pops by phase "
          + ", ".join(f"{p} {int(n_mc[1 + 3 * i])} ({int(n0[1 + 3 * i])})" for i, p in enumerate(phases_n)))
    table = [{
        "name": "frame_kernel", "route": "cuda",
        "source": "shader_ray_tpu_torch/csrc/frame_kernel.cu",
        "replaces": "shader_ray_tpu/ops/pallas/kernel_mega.py:57",
        "launches": launches["frame_kernel"], "max_abs_err": errs["frame_kernel"],
        "ms": ms, "plain_ms": float(np.median(plain_t)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "registers": frame_info["bilinear", False]["registers"],
        **grad_entry,
        "which5_ms": ms5, "which5_plain_ms": t5_p, "which5_bound_ms": b5_ms, "which5_bound_by": b5_by,
        "which5_registers": info5["registers"], "which5_make_fn_ms": float(np.median(e2e5)),
        "which5_unfused_make_fn_ms": float(np.median(e2e5_u)),
        "min_contrib_0.004_ms": float(np.median(t_mc)), "min_contrib_0.004_cast": int(n_mc[0]),
        "app_b_median_ms": float(np.median(app_b)), "app_b_p95_ms": float(np.percentile(app_b, 95)),
    }]

    # the trace kernels on the bench primaries: closest hit is the entry's
    # time, any-hit is printed beside it
    rays_f, P_f, D_f, _, _, _ = rays_at(W, H)
    all_f = torch.ones(P_f.shape[0], dtype=torch.bool, device="cuda")
    ray_io = P_f.shape[0] * (12 + 12 + 1 + 4 + 4 + 12 + 1)
    for name, kernel, plain, tables, tbytes, source, replaces, per_link, per_tri in (
        ("trace_wide", tk.trace_wide, tk.walk_plain, packed, wide_tables,
         "trace_kernel.cu", "kernel_wide.py:784", 0, OPS_WOOP),
        ("trace_binary", tk.trace_binary, tk.walk_binary_plain, packed_b,
         binary_bytes(packed_b, D_f), "trace_binary_kernel.cu", "kernel_body.py:244",
         OPS_PER_LINK, OPS_MT),
    ):
        out = {}
        for any_hit in (False, True):
            mode = "any-hit" if any_hit else "closest"
            t_k = cuda_times(lambda: kernel(tables, P_f, D_f, all_f, any_hit=any_hit, width=W), TIMED)
            walk, p_ms = compare_trace(name, kernel, plain, tables, P_f, D_f, all_f, any_hit,
                                       f"{mode}, primaries {W}x{H}", W)
            ops, work = walk_ops([walk], per_link, per_tri)
            b_ms, b_by = bound(ops, ray_io + tbytes)
            print(f"  {name} {mode}, {P_f.shape[0]} primaries (CUDA events): {summary(t_k)}; "
                  f"plain {p_ms:.1f} ms, n=1; bound: {work} -> "
                  f"{ops:.4g} ops ({ops / PEAK_F32 * 1e3:.4f} ms), {ray_io + tbytes} bytes "
                  f"({(ray_io + tbytes) / PEAK_BYTES * 1e3:.4f} ms): {b_ms:.4f} ms, by {b_by}")
            now, before = cache_bytes(name.removeprefix("trace_"), walk,
                                      0 if any_hit else int((walk.which >= 0).sum()))
            print(f"    loads through L1/L2, counted from the plain walk's work: {now} bytes "
                  f"({before} bytes in the layout before)")
            out[any_hit] = (float(np.median(t_k)), p_ms, b_ms, b_by)
        k_ms, p_ms, b_ms, b_by = out[False]
        table.append({
            "name": name, "route": "cuda", "source": f"shader_ray_tpu_torch/csrc/{source}",
            "replaces": f"shader_ray_tpu/ops/pallas/{replaces}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })

    # env_sample on the bench primaries' directions: mode 0 is the entry's
    # time (the which=0 frame's launch), grad with aniso=4 (the which=1
    # frame's) beside it as grad_ms / grad_bound_ms
    gx_f, gy_f = rays_f.dDdx.contiguous(), rays_f.dDdy.contiguous()
    R = D_f.shape[0]
    out = {}
    for what, grad, aniso in (("mode 0", False, 1), ("grad aniso=4", True, 4)):
        def launch():
            return ek.env_sample(pyramid, D_f, gx_f, gy_f, grad=grad, aniso=aniso)

        t_k = cuda_times(launch, TIMED)
        t_p = cuda_times(lambda: ek.env_sample_plain(pyramid, D_f, gx_f, gy_f, grad=grad, aniso=aniso), 5)
        # a launch of tens of microseconds: events around one call time the
        # host's launch gap too, so the entry's time is the kernel's own
        # device time where the profiler gives it
        parts = device_breakdown(launch, ("env_sample",), 20)
        k_ms = parts["env_sample"][0] if parts else float(np.median(t_k))
        compare_env(D_f, gx_f, gy_f, grad, aniso, f"{what}, primaries {W}x{H}")
        texels, fetches = env_needs(D_f, gx_f, gy_f, grad, aniso)
        ops = R * (OPS_ENV_COORDS + (OPS_ENV_GRAD if grad else 0)) + fetches * OPS_PER_FETCH
        moved = R * 12 * (4 if grad else 2) + texels
        b_ms, b_by = bound(ops, moved)
        print(f"  env_sample {what}, {R} directions: device time {k_ms:.4f} ms a launch "
              f"({'torch.profiler, 20 launches' if parts else 'profiler saw none: the events median'}); "
              f"CUDA events around one call {summary(t_k)}; "
              f"plain {summary(t_p)}; bound: {fetches} bilinear fetches, {ops:.4g} ops "
              f"({ops / PEAK_F32 * 1e3:.4f} ms), {moved} bytes of which {texels} of distinct texels "
              f"({moved / PEAK_BYTES * 1e3:.4f} ms): {b_ms:.4f} ms, by {b_by}"
              + (f"; lod on a level: {on_a_level(R, aniso, fetches)}" if grad else ""))
        out[grad] = (k_ms, float(np.median(t_p)), b_ms, b_by)
    k_ms, p_ms, b_ms, b_by = out[False]
    g_ms, g_p_ms, g_b_ms, g_b_by = out[True]
    table.append({
        "name": "env_sample", "route": "cuda",
        "source": "shader_ray_tpu_torch/csrc/env_kernel.cu",
        "replaces": "shader_ray_tpu/ops/pallas/envwin.py:445",
        "launches": launches["env_sample"], "max_abs_err": errs["env_sample"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "grad_ms": g_ms, "grad_plain_ms": g_p_ms, "grad_bound_ms": g_b_ms, "grad_bound_by": g_b_by,
    })

    # the unfused frame end to end, both table types, and the which=1 frame
    # (grad env, aniso 4) whose env launch is the grad kernel's main-path call
    for what, r, n, st in (("wide tables", unfused, 50, statics), ("binary tables", binary, 20, statics),
                           ("wide tables, which=1 env_aniso=4", unfused, 20,
                            statics._replace(which=1, env_aniso=4))):
        frame_u = r.make_fn(st)
        _build.LAUNCHES.clear()
        frame_u(params)
        per_frame = dict(_build.LAUNCHES)
        t_u = host_times(lambda: frame_u(params), n)
        print(f"  make_fn {W}x{H} unfused, {what}, end to end (host clock, synchronized "
              f"per frame): {summary(t_u)}; launches per frame {per_frame}")
        parts = device_breakdown(lambda: frame_u(params), tuple(per_frame), 10)
        if parts is None:
            print("    device time by kernel: not measured (the profiler saw no device time)")
        else:
            busy = sum(ms for ms, _ in parts.values())
            print("    device time per frame by kernel (torch.profiler, 10 frames): "
                  + ", ".join(f"{k} {ms:.3f} ms in {cnt:.0f} launches" for k, (ms, cnt) in parts.items())
                  + f"; busy {busy:.3f} ms = {busy / float(np.median(t_u)):.1%} of the frame's "
                  f"host-clock median")
        if st.which == 1:
            print(f"    beside it, the fused which=1 aniso=4 frame: kernel "
                  f"{grad_entry['which1_aniso4_ms']:.3f} ms (CUDA events, median), make_fn "
                  f"{float(np.median(grad_e2e[1])):.3f} ms end to end; which=2: kernel "
                  f"{grad_entry['which2_ms']:.3f} ms, make_fn {float(np.median(grad_e2e[2])):.3f} ms")
            # the rays of the frame's env call, caught from one more frame
            caught = []

            def catch(env, D, dDdx=None, dDdy=None, grad=False, aniso=1):
                caught.append((D, dDdx, dDdy, aniso))
                return ek.env_sample(env, D, dDdx, dDdy, grad=grad, aniso=aniso)

            engine_trace.env_sample = catch
            try:
                frame_u(params)
            finally:
                engine_trace.env_sample = ek.env_sample
            D1, gx1, gy1, aniso1 = caught[0]
            _, fetches = env_needs(D1, gx1, gy1, True, aniso1)
            print(f"    its env call, {D1.shape[0]} rays at aniso={aniso1}: lod on a level: "
                  f"{on_a_level(D1.shape[0], aniso1, fetches)}")
    print(f"  which=5 frame, unfused wide (host clock, one call): {t_which5 * 1e3:.1f} ms")

    # 8-9. the two other builds a user can ask for (Config.splits="sbvh",
    # Config.bvh_opt="reinsert") on the bench scene: the same geometry, so
    # the same golden; each a path of its own through the Renderer.  These
    # phases run after the timings above, so those see the process state
    # they saw before the phases existed
    base_row = fk.frame_kernel(packed, blk, one, fs0)[1].cpu()
    rays_p = generate_rays(statics, params_cuda)
    P_p, D_p = rays_p.P.contiguous(), rays_p.D.contiguous()
    all_p = torch.ones(P_p.shape[0], dtype=torch.bool, device="cuda")

    def built_tree_phase(tag: str, knobs: dict, traces: bool, base: str = "object split") -> dict:
        """Build the bench scene with ``knobs``; drive the fused which=0
        frame (and with ``traces`` the unfused frame on wide and on binary
        tables) through the Renderer, each through the golden gate, with
        the launch counts set to 0 before and read after; then hold the
        frame kernel (and the traces on the primaries, closest and
        any-hit) to their plain versions on these tables, and time the
        kernel beside the object-split tables' in turns."""
        import dataclasses

        from shader_ray_tpu_torch.models.fixtures import bunny_class_scene

        cfg_t = Config(**knobs)
        t0 = time.perf_counter()
        world_t = make_world(TriangleSet.from_arrays(*bunny_class_scene(69000)), cfg_t)
        data_t = get_shader_data(world_t)
        t_build = time.perf_counter() - t0
        ways = {"fused": Renderer(data_t, sky, cfg_t)}
        if traces:
            ways["unfused wide"] = Renderer(data_t, sky, dataclasses.replace(cfg_t, packet_fused=False))
            ways["unfused binary"] = Renderer(data_t, sky, dataclasses.replace(cfg_t, packet_kernel="binary"))
        pk = ways["fused"].packed
        T = world_t.triangle_count
        print(f"{tag}: build {t_build:.2f} s: {data_t.triangle_count} triangle references for {T} "
              f"triangles ({data_t.triangle_count / T - 1:+.2%}), {data_t.group_count} binary nodes "
              f"({base} {data.group_count}), {pk.n_wide} wide nodes ({base} "
              f"{packed.n_wide}), stack {pk.stack_depth}")
        _build.LAUNCHES.clear()
        for way, r in ways.items():
            golden_gate(r.make_fn(statics)(params).cpu().numpy(), GOLDEN, f"{tag}, {way} which=0")
        torch.cuda.synchronize()
        path = dict(_build.LAUNCHES)
        need = {"frame_kernel"} | ({"trace_wide", "trace_binary", "env_sample"} if traces else set())
        print(f"{tag} path launches: {path}")
        if set(path) != need:
            raise AssertionError(f"{tag}: the path must launch {sorted(need)}")
        kc, kn = fk.frame_kernel(pk, blk, one, fs0)
        pc, pn = fk.frame_plain(pk, uni, one, fs0)
        torch.cuda.synchronize()
        kn, pn = kn.cpu(), pn.cpu()
        names = fk.stats_phases(statics.bounce_count, statics.cast_shadows, statics.enable_diffuse)
        print(f"{tag}: frame_kernel vs plain {W}x{H}: mean abs {float((kc - pc).abs().mean()):.3e}, "
              f"cast {int(kn[0])} vs {int(pn[0])} ({base} {int(base_row[0])}); node pops, leaf "
              f"visits, triangle tests by phase, kernel [plain walks] ({base} kernel): "
              + "; ".join(f"{p} " + ", ".join(f"{int(kn[1 + 3 * i + c])} [{int(pn[1 + 3 * i + c])}] "
                                              f"({int(base_row[1 + 3 * i + c])})" for c in range(3))
                          for i, p in enumerate(names)))
        why = frame_disagreement(kc, kn, pc, pn)
        if why:
            raise AssertionError(f"{tag}: frame_kernel disagrees with frame_plain: {why}")
        if traces:
            for name, kernel, plain, way in (("trace_wide", tk.trace_wide, tk.walk_plain, "unfused wide"),
                                             ("trace_binary", tk.trace_binary, tk.walk_binary_plain,
                                              "unfused binary")):
                for any_hit in (False, True):
                    compare_trace(name, kernel, plain, ways[way].packed, P_p, D_p, all_p, any_hit,
                                  f"{tag}, {'any-hit' if any_hit else 'closest'}, primaries {W}x{H}", W)
        t = {base: [], tag: []}
        fns = {base: routed(packed, params, fs0), tag: routed(pk, params, fs0)}
        for which in (base, tag, tag, base):  # in turns on one card
            t[which] += cuda_times(fns[which], TIMED // 2)
        pops, base_pops = int(kn[1::3].sum()), int(base_row[1::3].sum())
        print(f"{tag}: frame_kernel {W}x{H} K=1 on {card} (CUDA events): {summary(t[tag])}; {base} "
              f"in turns {summary(t[base])}; node pops {pops} vs {base_pops} "
              f"({pops / base_pops - 1:+.2%}), triangle tests {int(kn[3::3].sum())} vs "
              f"{int(base_row[3::3].sum())}")
        return {"ms": float(np.median(t[tag])), "object_ms": float(np.median(t[base])),
                "pops": pops, "object_pops": base_pops, "launches": path, "build_s": t_build,
                "references": data_t.triangle_count}

    sbvh = built_tree_phase("sbvh", {"splits": "sbvh"}, True)
    reinsert = built_tree_phase("reinsert", {"bvh_opt": "reinsert"}, False)
    # 10-12. image backgrounds, the browser viewer, the CLI with the scene cache
    images_launches = images_phase(data)
    served = serve_phase(renderer, card)
    cli_cache_phase()
    # 13-16. multi-device, the native builder, the greedy collapse with the
    # quality simulator, the failure dump / debug_nans / trace
    meshed = mesh_phase(data, sky, params, {"fused": renderer, "unfused wide": unfused,
                                            "binary": binary}, card)
    natived = native_phase(sky, params, g_build["s"], card)
    greedy = built_tree_phase("greedy", {"collapse": "greedy"}, True, base="sah collapse")
    quality_phase(data)
    diag = diag_phase(renderer, params)

    # 17. the Moller-Trumbore leaf form of the 8-wide walk (Config.leaf_isect
    # = "mt"): its instantiations' resources, the path through the
    # Renderer's entry points, its kernels against their plain versions and
    # the trace against the brute-force oracle, both forms timed in turns
    def isect_phase() -> list[dict]:
        """The mt form on the bench scene.  Its launch resources beside the
        Woop form's (registers, spills, blocks an SM).  The path: fused
        which 0, 1 (aniso 4), 2 and 5, the count and stats fns, and the
        unfused which=0 frame, with the launch counts set to 0 before and
        read after (only frame_kernel_mt, trace_wide_mt and env_sample may
        run), gated on the bench goldens and held to the Woop frames.  Its
        kernels against their plain versions as the Woop form's are (the
        frame kernel at SMALL and on FRAME_CASES; the trace on the primaries
        and shadow rays, TRACE_CASES and the smooth sphere, and closest and
        any-hit on the bench primaries), the trace against
        ops/reference.intersect_brute on ORACLE_RAYS seeded primaries
        (oracle_disagreement), and the mt and Woop kernels timed in turns
        with CUDA events.  Returns the mt kernels' entries of the kernel
        table."""
        import dataclasses

        from shader_ray_tpu_torch.ops.reference import intersect_brute

        cfg_mt = Config(leaf_isect="mt")
        fused_mt = Renderer(data, sky, cfg_mt)
        unfused_mt = Renderer(data, sky, dataclasses.replace(cfg_mt, packet_fused=False))
        pk = fused_mt.packed
        same_nodes = torch.equal(pk.nodes.view(torch.int32), packed.nodes.view(torch.int32))
        same_normals = torch.equal(pk.normals, packed.normals)
        print(f"isect: mt tables: leaves {tuple(pk.leaves.shape)}, normals "
              f"{tuple(pk.normals.shape)}, {pk.n_wide} wide nodes, stack {pk.stack_depth} "
              f"(Woop: {packed.n_wide}, {packed.stack_depth}); the Woop tables' nodes and "
              f"normals, bit for bit: {same_nodes}, {same_normals}")
        if not (same_nodes and same_normals):
            raise AssertionError("isect: the mt tables' nodes or normals differ from Woop's")
        ptxas = {}
        for lib in ("frame_kernel", "trace_kernel"):
            for fn, res in ptxas_resources(_build.library(lib)[1]).items():
                if instantiation(fn):
                    ptxas[instantiation(fn)] = res
        res = {}
        for isect in ("woop", "mt"):
            for given in (False, True):
                for mode in fk.FRAME_MODES:
                    info = fk.launch_info(pk.stack_depth, mode, given, isect)
                    key = f"frame_kernel[{mode}, {'given rays' if given else 'raygen'}, {isect}]"
                    res[key] = info
            res[f"trace_wide[{isect}]"] = tk.launch_info("trace_wide", pk.stack_depth, isect)
        for key, info in res.items():
            regs, st, ld = ptxas.get(key, (None, None, None))
            print(f"isect: {key}: {info['registers']} registers (ptxas {regs}), spill stores "
                  f"{st} B, spill loads {ld} B, {info['local_bytes']} B local a thread, "
                  f"{info['blocks_per_sm']} blocks an SM")

        # the path through the Renderer's entry points
        _build.LAUNCHES.clear()
        golden_gate(fused_mt.make_fn(statics)(params).cpu().numpy(), GOLDEN, "mt, fused which=0")
        lin_mt = fused_mt.make_fn(linear)(params)
        grad_mt = {which: fused_mt.make_fn(linear._replace(which=which, env_aniso=aniso))(params)
                   for which, aniso in GRAD_MODES}
        golden_gate(fused_mt.make_fn(statics._replace(which=5))(params).cpu().numpy(), GOLDEN5,
                    "mt, fused which=5")
        cast_mt = fused_mt.make_count_fn(statics)(params)
        rows_mt = fused_mt.make_stats_fn(statics)(params)
        golden_gate(unfused_mt.make_fn(statics)(params).cpu().numpy(), GOLDEN, "mt, unfused which=0")
        lin_u = unfused_mt.make_fn(linear)(params)
        torch.cuda.synchronize()
        path = dict(_build.LAUNCHES)
        print(f"isect path launches: {path}")
        if set(path) != {"frame_kernel_mt", "trace_wide_mt", "env_sample"}:
            raise AssertionError("isect: the mt path must launch frame_kernel_mt, trace_wide_mt "
                                 "and env_sample, and no Woop instantiation")
        row_mt = fk.frame_kernel(pk, blk, torch.zeros((1, 2), device="cuda"), fs0)[1]
        d_woop = float((lin_mt - fused_linear).abs().mean())
        d_unf = float((lin_u - lin_mt).abs().mean())
        print(f"isect: mt fused frame vs Woop's: mean abs {d_woop:.3e} on linear colour (limit "
              f"1e-4), cast {cast_mt} vs {cast} (limit 1e-4 relative); unfused vs fused mt: mean "
              f"abs {d_unf:.3e} (limit 1e-5); stats rows sum to the frame's row: "
              f"{bool(torch.equal(rows_mt.sum(0), row_mt))}, rays cast {int(rows_mt[:, 0].sum())}")
        for which, aniso in GRAD_MODES:
            scale = max(1.0, float(fused_grad[which].abs().mean()))
            d = float((grad_mt[which] - fused_grad[which]).abs().mean())
            print(f"isect: mt fused which={which} aniso={aniso} vs Woop's: mean abs {d:.3e} "
                  f"(limit {1e-4 * scale:.3e})")
            if not torch.isfinite(grad_mt[which]).all() or d > 1e-4 * scale:
                raise AssertionError(f"isect: the mt which={which} frame strays from Woop's")
        if d_woop > 1e-4 or abs(cast_mt - cast) > 1e-4 * cast or d_unf > 1e-5 or \
                not torch.equal(rows_mt.sum(0), row_mt) or int(rows_mt[:, 0].sum()) != cast_mt:
            raise AssertionError("isect: the mt frames disagree with Woop's, each other or the "
                                 "stats rows")

        # the kernels against their plain versions
        compare_small(pk)
        frame_cases("mt")
        smooth = pack_scene_wide(sdata, procedural_sky(32), cfg_mt).to("cuda")
        trace_checks((("trace_wide_mt", tk.trace_wide, tk.walk_plain, pk, smooth),))

        # the trace against the brute-force oracle on seeded bench primaries
        pick = torch.from_numpy(np.random.default_rng(17).choice(P_f.shape[0], ORACLE_RAYS,
                                                                 replace=False)).cuda()
        Po, Do = P_f[pick].contiguous(), D_f[pick].contiguous()
        tris = torch.from_numpy(data.tri_positions.reshape(-1, 3, 3)).cuda()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = intersect_brute(tris, Po, Do)
        stop.record()
        got = tk.trace_wide(pk, Po, Do)
        torch.cuda.synchronize()
        e, why = oracle_disagreement(got, want, tris, Po, Do)
        print(f"isect: trace_wide_mt vs ops/reference.intersect_brute, {e['rays']} seeded bench "
              f"primaries x {tris.shape[0]} triangles ({start.elapsed_time(stop):.1f} ms): "
              f"{e['hits']} hit; on equal ids t max rel diff {e['t_rel_max']:.3e}, max "
              f"{e['t_over_limit_max']:.3f} of its limit (1e-6 of max(t, |P - v0|), widened "
              f"below |cos| 0.1); {e['differ']} rays with another id or hit flag (limit 1e-3 of the rays): "
              f"{e['ties']} tied, {e['grazing']} grazing an edge, {e['off']} neither (limit 0)")
        if why:
            raise AssertionError(f"isect: trace_wide_mt disagrees with the oracle: {why}")

        # the bench primaries: the plain walks' counted work gives the bounds
        out = {}
        for any_hit in (False, True):
            mode = "any-hit" if any_hit else "closest"
            walk, p_ms = compare_trace("trace_wide_mt", tk.trace_wide, tk.walk_plain, pk, P_f, D_f,
                                       all_f, any_hit, f"{mode}, primaries {W}x{H}", W)
            ops, work = walk_ops([walk], 0, OPS_MT)
            moved = ray_io + nbytes(pk.nodes, pk.leaves, pk.normals)
            out[any_hit] = (p_ms, *bound(ops, moved))
            print(f"isect: trace_wide_mt {mode} bound: {work} -> {ops:.4g} ops "
                  f"({ops / PEAK_F32 * 1e3:.4f} ms), {moved} bytes "
                  f"({moved / PEAK_BYTES * 1e3:.4f} ms): {out[any_hit][1]:.4f} ms, by "
                  f"{out[any_hit][2]}")
        probe = {}
        compare(W, H, one, probe, tables=pk)
        f_ops, f_work = walk_ops(probe["walks"], 0, OPS_MT)
        f_moved = nbytes(pk.nodes, pk.leaves, pk.normals) + \
            env_needs(probe["env_D"], None, None, False, 1)[0] + nbytes(uni) + W * H * 3 * 4
        del probe
        f_b_ms, f_b_by = bound(f_ops, f_moved)
        f_plain = cuda_times(lambda: fk.frame_plain(pk, uni, one, fs), 2)
        print(f"isect: frame_kernel_mt {W}x{H} K=1 bound: {f_work} -> {f_ops:.4g} ops "
              f"({f_ops / PEAK_F32 * 1e3:.4f} ms), {f_moved} bytes "
              f"({f_moved / PEAK_BYTES * 1e3:.4f} ms): {f_b_ms:.4f} ms, by {f_b_by} (Woop "
              f"{bound_ms:.4f} ms); frame_plain mt {summary(f_plain)}")

        # mt and Woop in turns on one card
        fs1 = fs._replace(which=1, env_aniso=4)
        series = {
            "frame_kernel which=0": (lambda t: routed(t, params, fs)),
            "frame_kernel which=1 aniso=4": (lambda t: routed(t, params, fs1)),
            "trace_wide closest": (lambda t: lambda: tk.trace_wide(t, P_f, D_f, all_f, width=W)),
            "trace_wide any-hit": (lambda t: lambda: tk.trace_wide(t, P_f, D_f, all_f,
                                                                   any_hit=True, width=W)),
        }
        med = {}
        for what, make in series.items():
            fns = {"woop": make(packed), "mt": make(pk)}
            t = {"woop": [], "mt": []}
            for form in ("woop", "mt", "mt", "woop"):
                t[form] += cuda_times(fns[form], TIMED // 2)
            med[what] = {form: float(np.median(v)) for form, v in t.items()}
            print(f"isect: {what} on {card} in turns (CUDA events): mt {summary(t['mt'])}; Woop "
                  f"{summary(t['woop'])}; mt / Woop {med[what]['mt'] / med[what]['woop']:.4f}")
        f_info, f_info_w = res["frame_kernel[bilinear, raygen, mt]"], \
            res["frame_kernel[bilinear, raygen, woop]"]
        t_info, t_info_w = res["trace_wide[mt]"], res["trace_wide[woop]"]
        frame_entry = {
            "name": "frame_kernel_mt", "route": "cuda",
            "source": "shader_ray_tpu_torch/csrc/frame_kernel.cu",
            "replaces": "shader_ray_tpu/ops/pallas/kernel_mega.py:57",
            "launches": path["frame_kernel_mt"], "max_abs_err": errs["frame_kernel_mt"],
            "ms": med["frame_kernel which=0"]["mt"], "plain_ms": float(np.median(f_plain)),
            "bound_ms": f_b_ms, "bound_by": f_b_by, "library_ms": None,
            "registers": f_info["registers"], "blocks_per_sm": f_info["blocks_per_sm"],
            "woop_ms_in_turns": med["frame_kernel which=0"]["woop"],
            "woop_registers": f_info_w["registers"],
            "which1_aniso4_ms": med["frame_kernel which=1 aniso=4"]["mt"],
            "which1_aniso4_woop_ms": med["frame_kernel which=1 aniso=4"]["woop"],
            "registers_by_instantiation": {k: v["registers"] for k, v in res.items()
                                           if k.startswith("frame_kernel")},
        }
        trace_entry = {
            "name": "trace_wide_mt", "route": "cuda",
            "source": "shader_ray_tpu_torch/csrc/trace_kernel.cu",
            "replaces": "shader_ray_tpu/ops/pallas/kernel_wide.py:784",
            "launches": path["trace_wide_mt"], "max_abs_err": errs["trace_wide_mt"],
            "ms": med["trace_wide closest"]["mt"], "plain_ms": out[False][0],
            "bound_ms": out[False][1], "bound_by": out[False][2], "library_ms": None,
            "registers": t_info["registers"], "blocks_per_sm": t_info["blocks_per_sm"],
            "woop_ms_in_turns": med["trace_wide closest"]["woop"],
            "woop_registers": t_info_w["registers"],
            "any_hit_ms": med["trace_wide any-hit"]["mt"],
            "any_hit_woop_ms": med["trace_wide any-hit"]["woop"],
            "any_hit_bound_ms": out[True][1],
            "oracle_rays": e["rays"], "oracle_t_rel_max": e["t_rel_max"],
            "oracle_ties": e["ties"], "oracle_grazes": e["grazing"],
        }
        return [frame_entry, trace_entry]

    table += isect_phase()
    # 18. the port's bench (shader_ray_tpu_torch/bench.py) at its defaults
    benched = bench_phase(renderer, params, cast, ms_batch, e2e_ms, card)
    # 19. the launch shapes, App.tune and the bench's BENCH_TUNE (phase tune, last)
    tuned = tune_phase(renderer, params, card)

    entry = {e["name"]: e for e in table}
    entry["frame_kernel"].update({
        "sbvh_ms": sbvh["ms"], "sbvh_object_split_ms": sbvh["object_ms"], "sbvh_node_pops": sbvh["pops"],
        "reinsert_ms": reinsert["ms"], "reinsert_object_split_ms": reinsert["object_ms"],
        "reinsert_node_pops": reinsert["pops"], "object_split_node_pops": sbvh["object_pops"],
        "sbvh_launches": sbvh["launches"]["frame_kernel"],
        "reinsert_launches": reinsert["launches"]["frame_kernel"],
        "images_launches": images_launches["frame_kernel"],
        "serve_launches": served["launches"]["frame_kernel"],
        "serve_render_ms": served["render_ms"], "serve_encode_png_ms": served["encode_ms"],
    })
    for name in ("trace_wide", "trace_binary", "env_sample"):
        entry[name]["sbvh_launches"] = sbvh["launches"][name]
    for name in entry:
        entry[name]["mesh_launches"] = meshed["launches"].get(name, 0)
        entry[name]["greedy_launches"] = greedy["launches"].get(name, 0)
    entry["frame_kernel"].update({
        "native_launches": natived["launches"]["frame_kernel"],
        "diag_launches": diag["launches"].get("frame_kernel", 0),
        "greedy_ms": greedy["ms"], "greedy_sah_ms": greedy["object_ms"],
        "greedy_node_pops": greedy["pops"], "sah_node_pops": greedy["object_pops"],
        "k64_ms": meshed["k64_ms"], "k64_sample_sharded_ms": meshed["k64_sample_sharded_ms"],
        "k64_sample_sharded_max_abs": meshed["k64_max_abs"],
        "k64_sample_sharded_max_scaled": meshed["k64_max_scaled"],
        "make_fn_one_device_ms": meshed["make_fn_one device_ms"],
        "make_fn_mesh1_ms": meshed["make_fn_[cuda:0]_ms"],
        "make_fn_mesh2_ms": meshed["make_fn_[cuda:0, cuda:0]_ms"],
        "native_build_s": natived["g++_s"], "native_scene_s": natived["native_s"],
        "numpy_scene_s": natived["numpy_s"],
        "bench_launches": benched["launches"]["frame_kernel"], "bench_s": benched["seconds"],
        "bench_frame_ms": benched["out"]["frame_ms"],
        "bench_frame_ms_single_dispatch": benched["out"]["frame_ms_single_dispatch"],
        "bench_k1024_mean_max_rel": benched["k_mean_rel"],
        "tune_launches": tuned["launches"]["frame_kernel"], "tune_best": tuned["best"],
        "tune_bench_best": tuned["bench_best"], "tune_shapes": tuned["shapes"],
        "tune_s": tuned["seconds"],
    })
    for name in entry:
        entry[name].setdefault("bench_launches", 0)
        entry[name].setdefault("tune_launches", 0)


    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
