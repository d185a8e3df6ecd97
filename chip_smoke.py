#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (shader_ray_tpu_torch).

Builds the bench scene (bunny-class 69k triangles, procedural_sky(2048),
1024x768, 3 bounces, shadows on) from a seed-free procedural fixture,
builds the four CUDA kernels with nvcc (all started together), holds each
kernel against its plain PyTorch version on the card, and drives the
port's two paths through the Renderer's entry points:

* the fused path (``frame_kernel``): make_fn, make_progressive_fn,
  make_count_fn at which=0, gated on tests/golden/bench_which0.npy;
* the unfused path (``trace_wide``, ``trace_binary``, ``env_sample``):
  ``Config(packet_fused=False)`` and ``Config(packet_kernel="binary")``
  at which=0 (held to the fused frame and the same golden), which=5
  (gated on tests/golden/bench_which5_oracle.npy), which=1/2/3.

The frame kernel is also held to its plain version on the control-flow
cases of its wave compaction (FRAME_CASES), and its launch resources
(registers, shared memory, blocks an SM) are printed.  Each path runs
with the launch counts set to 0 just before it and read just after.
Then it times every kernel with CUDA events at the main path's shapes
beside its bound and its plain version, the frame kernel also beside
the same frame's six walks as separate trace_wide launches, and prints
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
# tiles, early exits), held to frame_plain here and in
# tests/test_torch_isolation.py
FRAME_CASES = ("all-miss", "all-hit", "bad", "bounces0", "bounces1-noshadow",
               "nodiffuse", "k3-ragged")


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
    """(packed tables, uniforms, jitters, FrameSettings) of one control
    flow case on ``device``: a 5000-triangle bench-like scene (the inside
    of a closed sphere for "all-hit")."""
    import dataclasses

    import numpy as np
    import torch

    from shader_ray_tpu_torch.ops.engine_frame import halton_jitters, pack_uniforms
    from shader_ray_tpu_torch.ops.frame_kernel import FrameSettings
    from shader_ray_tpu_torch.ops.render import default_frame_params
    from shader_ray_tpu_torch.utils import mat4

    inside = name == "all-hit"
    packed = _case_tables(inside)
    if name == "bad":
        packed = dataclasses.replace(packed, stack_depth=2)
    params = default_frame_params()._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0.0, 0.0, 0.0 if inside else 3.8)),
        light_dir=torch.tensor([0.36, 0.48, 0.8]),
        diffuse_color=torch.tensor([0.8, 0.2, 0.2]),
        specular_color=torch.tensor([0.3, 0.3, 0.3]),
    )
    if name == "all-miss":  # the camera turned away from the scene
        params = params._replace(camera_normal_matrix=torch.from_numpy(
            mat4.make_rotation(np.pi, 0.0, 1.0, 0.0)))
    fs = FrameSettings(width=64, height=48)
    k = 1
    if name == "bounces0":
        fs = fs._replace(bounce_count=0)
    elif name == "bounces1-noshadow":
        fs = fs._replace(bounce_count=1, cast_shadows=False)
    elif name == "nodiffuse":
        fs = fs._replace(enable_diffuse=False)
    elif name == "k3-ragged":
        fs = fs._replace(width=37, height=29)
        k = 3
    jit = torch.from_numpy(halton_jitters(k)).to(device)
    return packed.to(device), pack_uniforms(params).to(device), jit, fs


def case_unmet(name: str, fs, colour, counters) -> str | None:
    """What a case's plain frame fails to show of the path it is for,
    or None."""
    import torch

    k = 3 if name == "k3-ragged" else 1
    primaries = k * fs.width * fs.height
    cast = int(counters[0])
    painted = int((colour == torch.tensor([1.0, 0.0, 0.0], device=colour.device)).all(-1).sum())
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
    length and finite colour."""
    import torch

    cast_k, cast_p = int(kn[0]), int(pn[0])
    if kc.shape != pc.shape or kn.shape != pn.shape:
        return f"shapes {tuple(kc.shape)} {tuple(kn.shape)} vs {tuple(pc.shape)} {tuple(pn.shape)}"
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


def bench_inputs():
    """The bench configuration (bench.py:289-331): the 69k-triangle
    bunny-class scene, procedural_sky(2048) and the bench camera, as
    (SceneData, sky, FrameParams on the CPU)."""
    import numpy as np
    import torch

    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops.render import default_frame_params
    from shader_ray_tpu_torch.utils import mat4

    pos, nrm = bunny_class_scene(69000)
    data = get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm)))
    fov = np.deg2rad(40.0)
    zoom = 2.6 / 2.0 / np.sin(fov / 2.0)
    params = default_frame_params(fov=fov)._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0.0, 0.0, zoom)),
        diffuse_color=torch.tensor([0.8, 0.2, 0.2]),
        specular_color=torch.tensor([0.05, 0.05, 0.05]),
    )
    return data, procedural_sky(2048), params


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
    info = fk.launch_info(packed.stack_depth)
    print(f"frame_kernel launch at stack {packed.stack_depth}: {info['registers']} registers, "
          f"{info['local_bytes']} B local a thread, shared {info['static_smem']} B static + "
          f"{info['dynamic_smem']} B stack a block, {info['threads']} threads a block "
          f"({info['tile_w']}x{info['tile_h']} tile), {info['blocks_per_sm']} blocks an SM")
    params_cuda = type(params)(*[x.cuda() for x in params])
    uni = pack_uniforms(params).cuda()
    statics = RenderStatics(width=W, height=H)
    linear = statics._replace(do_tonemap=False)
    errs = dict.fromkeys(("frame_kernel", "trace_wide", "trace_binary", "env_sample"), 0.0)

    # 4. each kernel vs its plain version on the card
    def compare(w: int, h: int, jit: torch.Tensor, probe: dict | None = None):
        k = jit.shape[0]
        fs = fk.FrameSettings(width=w, height=h)
        kc, kn = fk.frame_kernel(packed, uni, jit, fs)
        pc, pn = fk.frame_plain(packed, uni, jit, fs, probe)
        torch.cuda.synchronize()
        diff = (kc - pc).abs()
        errs["frame_kernel"] = max(errs["frame_kernel"], float(diff.max()))
        kn, pn = kn.cpu(), pn.cpu()
        cast_rel = abs(int(kn[0]) - int(pn[0])) / max(int(pn[0]), 1)
        excess, i = walk_counter_excess(kn, pn)
        print(f"frame_kernel vs plain {w}x{h} K={k}: max abs {float(diff.max()):.3e}, "
              f"mean abs {float(diff.mean()):.3e}; cast {int(kn[0])} vs {int(pn[0])} "
              f"(rel {cast_rel:.2e}); walk counters: worst {int(kn[i])} vs {int(pn[i])} "
              f"(counter {i}), {excess:.3f} of its limit")
        why = frame_disagreement(kc, kn, pc, pn)
        if why:
            raise AssertionError(f"frame_kernel disagrees with frame_plain at {w}x{h} K={k}: {why}")

    compare(*SMALL, torch.from_numpy(halton_jitters(1)).cuda())
    compare(*SMALL, torch.from_numpy(halton_jitters(4)).cuda())
    red = torch.tensor([1.0, 0.0, 0.0], device="cuda")
    for name in FRAME_CASES:
        c_packed, c_uni, c_jit, c_fs = frame_case(name, torch.device("cuda"))
        kc, kn = fk.frame_kernel(c_packed, c_uni, c_jit, c_fs)
        pc, pn = fk.frame_plain(c_packed, c_uni, c_jit, c_fs)
        torch.cuda.synchronize()
        painted = int((kc == red).all(-1).sum()), int((pc == red).all(-1).sum())
        print(f"frame_kernel vs plain, case {name} ({c_fs.width}x{c_fs.height} K={c_jit.shape[0]}, "
              f"{c_fs.bounce_count} bounces, shadows {c_fs.cast_shadows}, diffuse "
              f"{c_fs.enable_diffuse}): mean abs {float((kc - pc).abs().mean()):.3e}, cast "
              f"{int(kn[0])} vs {int(pn[0])}, walk counters {kn[1:].sum().item()} vs "
              f"{pn[1:].sum().item()} (worst {walk_counter_excess(kn.cpu(), pn.cpu())[0]:.3f} "
              f"of its limit), bad-painted pixels {painted[0]} vs {painted[1]}")
        why = frame_disagreement(kc, kn.cpu(), pc, pn.cpu()) or case_unmet(name, c_fs, pc, pn.cpu())
        if why or abs(painted[0] - painted[1]) > max(1e-4 * kc[..., 0].numel(), 1):
            raise AssertionError(f"frame_kernel disagrees with frame_plain on case {name}: {why}")

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

    def compare_trace(name, kernel, plain, tables, P, D, active, any_hit, what):
        """nvcc contracts multiply-adds into FMAs, the plain version does
        not, so a grazing ray may take another triangle or none.  Limits:
        hit flags flip on <= 0.1% of rays; where both versions hit, t
        agrees to 1e-4 * max(1, t) and ids are equal or tied
        (|dt| < 1e-6 * max(1, t)) on all but 0.01% of rays, and the mean
        |dt| is <= 1e-5; bad flags are equal; the kernel's own step, leaf
        and triangle-test totals are within 1e-3 of the plain walk's; on
        closest hits with equal ids the interpolated normals (length ~1)
        agree to 1e-5 mean abs.
        Returns the plain walk's result and its device time (one call)."""
        got = kernel(tables, P, D, active, any_hit=any_hit, with_stats=True)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        walk = plain(tables, P, D, active, any_hit)
        want = tk.packet_hit(walk, True)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        hit, hit_w = got.t < FAR, want.t < FAR
        flips = float((hit != hit_w).float().mean())
        both = hit & hit_w
        dt = (got.t - want.t).abs()
        scale = want.t.abs().clamp_min(1.0)
        t_err = float(dt[both].max()) if both.any() else 0.0
        t_mean = float(dt[both].mean()) if both.any() else 0.0
        t_off = float((both & (dt > 1e-4 * scale)).float().mean())
        ids = float((both & (got.which != want.which) & (dt >= 1e-6 * scale)).float().mean())
        bad_equal = bool(torch.equal(got.bad, want.bad))
        errs[name] = max(errs[name], t_err)
        stats = got.stats.sum(0).tolist()
        counted = [int(walk.steps.sum()), int(walk.leafs.sum()), int(walk.tris.sum())]
        stats_rel = max(abs(a - b) / max(b, 1) for a, b in zip(stats, counted))
        n_mean = n_max = 0.0
        if not any_hit:
            same = both & (got.which == want.which)
            if same.any():  # a convex scene's shadow rays hit next to nothing
                dn = (got.normal - want.normal)[same].abs()
                n_mean, n_max = float(dn.mean()), float(dn.max())
                errs[name] = max(errs[name], n_max)
        print(f"{name} vs plain, {what} ({P.shape[0]} rays, {int(active.sum())} active, "
              f"{int(hit.sum())} hit): t mean abs {t_mean:.3e} (limit 1e-5), max abs {t_err:.3e}, "
              f"rays off by > 1e-4 {t_off:.2e} (limit 1e-4), hit flips {flips:.2e} (limit 1e-3), "
              f"id mismatches outside ties {ids:.2e} (limit 1e-4), bad equal {bad_equal}, "
              f"walk counters max rel diff {stats_rel:.2e} (limit 1e-3)"
              + ("" if any_hit else f", normal mean abs {n_mean:.3e} (limit 1e-5), max abs {n_max:.3e}"))
        if (t_mean > 1e-5 or t_off > 1e-4 or flips > 1e-3 or ids > 1e-4 or not bad_equal
                or stats_rel > 1e-3 or n_mean > 1e-5):
            raise AssertionError(f"{name} disagrees with its plain version on {what}")
        if (got.t[~active] != FAR).any() or (got.which[~active] != -1).any():
            raise AssertionError(f"{name}: an inactive ray did not return a miss")
        return walk, plain_ms

    def compare_env(D, gx, gy, grad, aniso, what):
        """Mean abs <= 1e-5 and max abs <= 1e-2 on radiance that reaches
        ~50 at the sun: both versions call the card's atan2f/acosf/log2f
        and differ by FMA contraction in the texel coordinates."""
        got = ek.env_sample(pyramid, D, gx, gy, grad=grad, aniso=aniso)
        want = ek.env_sample_plain(pyramid, D, gx, gy, grad=grad, aniso=aniso)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        errs["env_sample"] = max(errs["env_sample"], float(diff.max()))
        print(f"env_sample vs plain, {what} ({D.shape[0]} rays): max abs {float(diff.max()):.3e} "
              f"(limit 1e-2), mean abs {float(diff.mean()):.3e} (limit 1e-5)")
        if not torch.isfinite(got).all():
            raise AssertionError(f"env_sample produced non-finite radiance on {what}")
        if float(diff.max()) > 1e-2 or float(diff.mean()) > 1e-5:
            raise AssertionError(f"env_sample disagrees with its plain version on {what}")

    def env_bytes(D, gx, gy, grad, aniso) -> int:
        """Bytes of the distinct pyramid texels the lookup of these rays
        reads (marked by the plain version)."""
        touched = torch.zeros(pyramid.texels.shape[0], dtype=torch.bool, device="cuda")
        ek.env_sample_plain(pyramid, D, gx, gy, grad=grad, aniso=aniso, touched=touched)
        return int(touched.sum()) * 12

    rays_s, P_s, D_s, sP_s, sD_s, sact_s = rays_at(*SMALL)
    all_s = torch.ones_like(sact_s)
    size = f"{SMALL[0]}x{SMALL[1]}"
    for name, kernel, plain, tables in (
        ("trace_wide", tk.trace_wide, tk.walk_plain, packed),
        ("trace_binary", tk.trace_binary, tk.walk_binary_plain, packed_b),
    ):
        compare_trace(name, kernel, plain, tables, P_s, D_s, all_s, False, f"closest, primaries {size}")
        compare_trace(name, kernel, plain, tables, P_s, D_s, all_s, True, f"any-hit, primaries {size}")
        compare_trace(name, kernel, plain, tables, sP_s, sD_s, sact_s, False, f"closest, shadow rays {size}")
        compare_trace(name, kernel, plain, tables, sP_s, sD_s, sact_s, True, f"any-hit, shadow rays {size}")
    # the bench scene is flat-shaded (one normal a triangle), so the normal
    # interpolation is held to the plain versions on a smooth unit sphere
    spos, snrm = uv_sphere(lat=64, lon=128)
    sdata = get_shader_data(make_world(TriangleSet.from_arrays(spos, snrm)))
    for name, kernel, plain, tables in (
        ("trace_wide", tk.trace_wide, tk.walk_plain, pack_scene_wide(sdata, procedural_sky(32)).to("cuda")),
        ("trace_binary", tk.trace_binary, tk.walk_binary_plain, pack_scene(sdata, procedural_sky(32)).to("cuda")),
    ):
        walk, _ = compare_trace(name, kernel, plain, tables, P_s, D_s, all_s, False,
                                f"closest, smooth sphere, primaries {size}")
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
    wide_tables = nbytes(packed.nodes, packed.leaves)
    moved = wide_tables + env_bytes(probe["env_D"], None, None, False, 1) + nbytes(uni) + W * H * 3 * 4
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
    table = [{
        "name": "frame_kernel", "route": "cuda",
        "source": "shader_ray_tpu_torch/csrc/frame_kernel.cu",
        "replaces": "shader_ray_tpu/ops/pallas/kernel_mega.py:57",
        "launches": launches["frame_kernel"], "max_abs_err": errs["frame_kernel"],
        "ms": ms, "plain_ms": float(np.median(plain_t)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
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
         nbytes(packed_b.links, packed_b.boxes, packed_b.leaf, packed_b.tris),
         "trace_binary_kernel.cu", "kernel_body.py:244", OPS_PER_LINK, OPS_MT),
    ):
        out = {}
        for any_hit in (False, True):
            mode = "any-hit" if any_hit else "closest"
            t_k = cuda_times(lambda: kernel(tables, P_f, D_f, all_f, any_hit=any_hit), TIMED)
            walk, p_ms = compare_trace(name, kernel, plain, tables, P_f, D_f, all_f, any_hit,
                                       f"{mode}, primaries {W}x{H}")
            ops, work = walk_ops([walk], per_link, per_tri)
            b_ms, b_by = bound(ops, ray_io + tbytes)
            print(f"  {name} {mode}, {P_f.shape[0]} primaries (CUDA events): {summary(t_k)}; "
                  f"plain {p_ms:.1f} ms, n=1; bound: {work} -> "
                  f"{ops:.4g} ops ({ops / PEAK_F32 * 1e3:.4f} ms), {ray_io + tbytes} bytes "
                  f"({(ray_io + tbytes) / PEAK_BYTES * 1e3:.4f} ms): {b_ms:.4f} ms, by {b_by}")
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
    # time (the which=0 frame's launch), grad with aniso=4 beside it
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
        fetches = 2 * 4 if grad else 1
        ops = R * (OPS_ENV_COORDS + (OPS_ENV_GRAD if grad else 0) + fetches * OPS_PER_FETCH)
        texels = env_bytes(D_f, gx_f, gy_f, grad, aniso)
        moved = R * 12 * (4 if grad else 2) + texels
        b_ms, b_by = bound(ops, moved)
        print(f"  env_sample {what}, {R} directions: device time {k_ms:.4f} ms a launch "
              f"({'torch.profiler, 20 launches' if parts else 'profiler saw none: the events median'}); "
              f"CUDA events around one call {summary(t_k)}; "
              f"plain {summary(t_p)}; bound: {ops:.4g} ops ({ops / PEAK_F32 * 1e3:.4f} ms), "
              f"{moved} bytes of which {texels} of distinct texels "
              f"({moved / PEAK_BYTES * 1e3:.4f} ms): {b_ms:.4f} ms, by {b_by}")
        out[grad] = (k_ms, float(np.median(t_p)), b_ms, b_by)
    k_ms, p_ms, b_ms, b_by = out[False]
    table.append({
        "name": "env_sample", "route": "cuda",
        "source": "shader_ray_tpu_torch/csrc/env_kernel.cu",
        "replaces": "shader_ray_tpu/ops/pallas/envwin.py:445",
        "launches": launches["env_sample"], "max_abs_err": errs["env_sample"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })

    # the unfused frame end to end, both table types
    for what, r, n in (("wide", unfused, 50), ("binary", binary, 20)):
        frame_u = r.make_fn(statics)
        _build.LAUNCHES.clear()
        frame_u(params)
        per_frame = dict(_build.LAUNCHES)
        t_u = host_times(lambda: frame_u(params), n)
        print(f"  make_fn {W}x{H} unfused, {what} tables, end to end (host clock, synchronized "
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
    print(f"  which=5 frame, unfused wide (host clock, one call): {t_which5 * 1e3:.1f} ms")

    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
