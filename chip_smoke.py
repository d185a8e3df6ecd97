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
  and the CLI ``python -m shader_ray_tpu_torch`` once as a subprocess.

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
0.004, and prints
one JSON line with the kernel table plus a final status line.

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

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {name: [0.0, 0.0] for name in (*ours, "other")}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
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
def _case_tables(inside: bool):
    """The cases' packed tables on the CPU: a closed sphere, or a
    5000-triangle bunny-class scene."""
    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky, uv_sphere
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide

    pos, nrm = uv_sphere(lat=12, lon=16) if inside else bunny_class_scene(5000)
    return pack_scene_wide(get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm))),
                           procedural_sky(256))


def frame_case(name: str, device):
    """(packed tables, uniforms, jitters, FrameSettings, given rays) of
    one case on ``device``: a 5000-triangle bench-like scene (the inside
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
    packed = _case_tables(inside)
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


def _retired_unmet(name: str, fs, colour, counters) -> bool:
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
    packed, uni, jit, _, _ = frame_case(name, colour.device)
    exact, exact_n = fk.frame_plain(packed, uni, jit, fs._replace(min_contrib=0.0))
    err = float((colour - exact).abs().max()) if colour.shape == exact.shape else float("inf")
    return not int(counters[0]) < int(exact_n[0]) or err > 3 * fs.min_contrib


def case_unmet(name: str, fs, colour, counters) -> str | None:
    """What a case's plain frame fails to show of the path it is for,
    or None.  An env-mode case bounces some rays (their differentials
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
        unmet = _retired_unmet(name, fs, colour, counters)
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
    from shader_ray_tpu_torch.models.world import make_world

    return make_world(TriangleSet.from_arrays(*bunny_class_scene(69000)))


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
    if bad or shot.shape != (H, W, 3) or set(app_launches) != {"frame_kernel"} or 5 not in whiches:
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
        env = {**os.environ, "PYTHONPATH": ROOT}
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
    from shader_ray_tpu_torch.ops.engine_frame import halton_jitters, pack_uniforms
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

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    _build.build(KERNEL_SOURCES)
    print(f"build: nvcc x{len(KERNEL_SOURCES)} in parallel {time.perf_counter() - t0:.2f} s")
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
    statics = RenderStatics(width=W, height=H)
    linear = statics._replace(do_tonemap=False)
    errs = dict.fromkeys(("frame_kernel", "trace_wide", "trace_binary", "env_sample"), 0.0)

    # 4. each kernel vs its plain version on the card
    def compare(w: int, h: int, jit: torch.Tensor, probe: dict | None = None, which: int = 0,
                aniso: int = 1):
        k = jit.shape[0]
        fs = fk.FrameSettings(width=w, height=h, which=which, env_aniso=aniso)
        kc, kn = fk.frame_kernel(packed, uni, jit, fs)
        pc, pn = fk.frame_plain(packed, uni, jit, fs, probe)
        torch.cuda.synchronize()
        diff = (kc - pc).abs()
        errs["frame_kernel"] = max(errs["frame_kernel"], float(diff.nan_to_num(0.0).max()))
        kn, pn = kn.cpu(), pn.cpu()
        cast_rel = abs(int(kn[0]) - int(pn[0])) / max(int(pn[0]), 1)
        excess, i = walk_counter_excess(kn, pn)
        print(f"frame_kernel vs plain {w}x{h} K={k} which={which} aniso={aniso}: max abs "
              f"{float(diff.max()):.3e}, mean abs {float(diff.mean()):.3e}; cast {int(kn[0])} vs "
              f"{int(pn[0])} (rel {cast_rel:.2e}); walk counters: worst {int(kn[i])} vs "
              f"{int(pn[i])} (counter {i}), {excess:.3f} of its limit")
        why = frame_disagreement(kc, kn, pc, pn)
        if why:
            raise AssertionError(f"frame_kernel disagrees with frame_plain at {w}x{h} K={k} "
                                 f"which={which} aniso={aniso}: {why}")

    compare(*SMALL, torch.from_numpy(halton_jitters(1)).cuda())
    compare(*SMALL, torch.from_numpy(halton_jitters(4)).cuda())
    for which, aniso in ((1, 1), (1, 4), (2, 1)):
        compare(*SMALL, torch.from_numpy(halton_jitters(2)).cuda(), which=which, aniso=aniso)
    red = torch.tensor([1.0, 0.0, 0.0], device="cuda")
    for name in FRAME_CASES:
        c_packed, c_uni, c_jit, c_fs, c_rays = frame_case(name, torch.device("cuda"))
        kc, kn = fk.frame_kernel(c_packed, c_uni, c_jit, c_fs, rays=c_rays)
        pc, pn = fk.frame_plain(c_packed, c_uni, c_jit, c_fs, rays=c_rays)
        torch.cuda.synchronize()
        painted = int((kc == red).all(-1).sum()), int((pc == red).all(-1).sum())
        print(f"frame_kernel vs plain, case {name} ({c_fs.width}x{c_fs.height} "
              f"K={CASE_SAMPLES.get(name, 1)}{', given rays' if c_rays else ''}, "
              f"{c_fs.bounce_count} bounces, shadows {c_fs.cast_shadows}, diffuse "
              f"{c_fs.enable_diffuse}, which {c_fs.which}, aniso {c_fs.env_aniso}, min_contrib "
              f"{c_fs.min_contrib}): NaN pixels "
              f"{int(torch.isnan(kc).any(-1).sum())} vs {int(torch.isnan(pc).any(-1).sum())}, "
              f"mean abs {float((kc - pc).abs().nanmean()):.3e}, cast "
              f"{int(kn[0])} vs {int(pn[0])}, walk counters {kn[1:].sum().item()} vs "
              f"{pn[1:].sum().item()} (worst {walk_counter_excess(kn.cpu(), pn.cpu())[0]:.3f} "
              f"of its limit), bad-painted pixels {painted[0]} vs {painted[1]}")
        why = frame_disagreement(kc, kn.cpu(), pc, pn.cpu()) or case_unmet(name, c_fs, pc, pn.cpu())
        if why or abs(painted[0] - painted[1]) > max(1e-4 * kc[..., 0].numel(), 1):
            raise AssertionError(f"frame_kernel disagrees with frame_plain on case {name}: {why}")
        if c_fs.min_contrib >= 1.0:
            # every hit lane retires after bounce 0: the kernel's own
            # one-bounce frame, bit for bit, and no later walk
            oc, on = fk.frame_kernel(c_packed, c_uni, c_jit, c_fs._replace(bounce_count=1))
            same = torch.equal(kc, oc) and torch.equal(kn[:on.numel()], on) and \
                not kn[on.numel():].any()
            print(f"  case {name}: the kernel's frame equals its bounce_count=1 frame bit for bit, "
                  f"colour and counters: {same}")
            if not same:
                raise AssertionError(f"case {name}: not the kernel's bounce_count=1 frame")

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
    for name, kernel, plain, tables in (
        ("trace_wide", tk.trace_wide, tk.walk_plain, packed),
        ("trace_binary", tk.trace_binary, tk.walk_binary_plain, packed_b),
    ):
        for what, Pr, Dr, act in (("primaries", P_s, D_s, all_s), ("shadow rays", sP_s, sD_s, sact_s)):
            for any_hit in (False, True):
                compare_trace(name, kernel, plain, tables, Pr, Dr, act, any_hit,
                              f"{'any-hit' if any_hit else 'closest'}, {what} {size}", SMALL[0])
    # the masks' and layouts' edges (TRACE_CASES) on the same primaries: each
    # case's plain walks show its path, the kernels are held to them
    for case in TRACE_CASES:
        cP, cD, cact, cw = trace_case(case, P_s, D_s)
        for name, kernel, plain, tables in (
            ("trace_wide", tk.trace_wide, tk.walk_plain, packed),
            ("trace_binary", tk.trace_binary, tk.walk_binary_plain, packed_b),
        ):
            for any_hit in (False, True):
                walk, _ = compare_trace(name, kernel, plain, tables, cP, cD, cact, any_hit,
                                        f"{'any-hit' if any_hit else 'closest'}, case {case}", cw)
                why = trace_case_unmet(case, cact, walk.steps)
                if why:
                    raise AssertionError(f"{name}: {why}")
    # the bench scene is flat-shaded (one normal a triangle), so the normal
    # interpolation is held to the plain versions on a smooth unit sphere
    spos, snrm = uv_sphere(lat=64, lon=128)
    sdata = get_shader_data(make_world(TriangleSet.from_arrays(spos, snrm)))
    for name, kernel, plain, tables in (
        ("trace_wide", tk.trace_wide, tk.walk_plain, pack_scene_wide(sdata, procedural_sky(32)).to("cuda")),
        ("trace_binary", tk.trace_binary, tk.walk_binary_plain, pack_scene(sdata, procedural_sky(32)).to("cuda")),
    ):
        walk, _ = compare_trace(name, kernel, plain, tables, P_s, D_s, all_s, False,
                                f"closest, smooth sphere, primaries {size}", SMALL[0])
        inside = (walk.t < FAR) & ((walk.normal.norm(dim=1) - 1.0).abs() > 1e-4)
        if int(inside.sum()) < 1000:
            raise AssertionError(f"{name}: the smooth sphere gave no interpolated normals to compare")
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
    frame_row = fk.frame_kernel(packed, uni, torch.zeros((1, 2), device="cuda"), fs0)[1]
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
    kernel_t = cuda_times(lambda: fk.frame_kernel(packed, uni, one, fs), TIMED)
    ms = float(np.median(kernel_t))
    batch_t = [t / BATCH_K for t in cuda_times(lambda: fk.frame_kernel(packed, uni, batch, fs), 5)]
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
    fns = {"fused": lambda: fk.frame_kernel(packed, uni, one, fs), "walks": six_walks}
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
        t_k = cuda_times(lambda: fk.frame_kernel(packed, uni, one, fsg), TIMED)
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
    t5_k = cuda_times(lambda: fk.frame_kernel(packed, uni, None, fs, rays=given5), 20)
    k5, n5 = fk.frame_kernel(packed, uni, None, fs, rays=given5)
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
    t_mc = cuda_times(lambda: fk.frame_kernel(packed, uni, one, fs_mc), TIMED)
    c_mc, n_mc = fk.frame_kernel(packed, uni, one, fs_mc)
    n0 = fk.frame_kernel(packed, uni, one, fs)[1]
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

    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
