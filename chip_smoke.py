#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (shader_ray_tpu_torch).

Builds the bench scene (bunny-class 69k triangles, procedural_sky(2048),
1024x768, 3 bounces, shadows on, which=0) from a seed-free procedural
fixture, builds the frame kernel with nvcc, holds the kernel against its
plain PyTorch version, drives the port's main path (Renderer.make_fn,
make_progressive_fn, make_count_fn), checks the frame against the
committed golden, times the kernel with CUDA events, and prints one JSON
line per the kernel table plus a final status line.

    python3 chip_smoke.py        # from the repo root, on a machine with one NVIDIA GPU

Exits non-zero (and prints no result) without a CUDA device or outside
a checkout of the repository.
"""

from __future__ import annotations

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
TIMED = 200  # timed calls per series (p95 has 10 beyond it)
GOLDEN = os.path.join(ROOT, "tests", "golden", "bench_which0.npy")

# bound model (ops the kernel issues, f32, FMA = 2): a node pop slab-tests
# 8 children at ~26 ops each; a Woop triangle test is ~47 ops
OPS_PER_POP = 8 * 26
OPS_PER_TRI = 47
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
    """Median and p95 (>= 10 samples beyond it at n >= 200) with n."""
    import numpy as np

    return (f"median {np.median(ms):.3f} ms, p95 {np.percentile(ms, 95):.3f} ms, "
            f"n={len(ms)}")


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

    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops import frame_kernel as fk
    from shader_ray_tpu_torch.ops.engine_frame import halton_jitters, pack_uniforms
    from shader_ray_tpu_torch.ops.render import RenderStatics, default_frame_params
    from shader_ray_tpu_torch.utils import mat4

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    report = fk.build_report()
    print(f"build: nvcc frame_kernel.cu {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. scene: the bench configuration (bench.py:322-331)
    t0 = time.perf_counter()
    pos, nrm = bunny_class_scene(69000)
    data = get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm)))
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    renderer = Renderer(data, procedural_sky(2048))
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    packed = renderer.packed
    print(f"scene: {data.triangle_count} triangles, {data.group_count} binary nodes, "
          f"{packed.n_wide} wide nodes, stack {packed.stack_depth}; "
          f"build {t_build:.2f} s, pack+upload {t_pack:.2f} s")
    fov = np.deg2rad(40.0)
    zoom = 2.6 / 2.0 / np.sin(fov / 2.0)
    params = default_frame_params(fov=fov)._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0.0, 0.0, zoom)),
        diffuse_color=torch.tensor([0.8, 0.2, 0.2]),
        specular_color=torch.tensor([0.05, 0.05, 0.05]),
    )
    uni = pack_uniforms(params).cuda()
    statics = RenderStatics(width=W, height=H)
    linear = statics._replace(do_tonemap=False)

    # 4. kernel vs plain on the card
    max_abs_err = 0.0

    def compare(w: int, h: int, jit: torch.Tensor):
        nonlocal max_abs_err
        k = jit.shape[0]
        fs = fk.FrameSettings(width=w, height=h)
        kc, kn = fk.frame_kernel(packed, uni, jit, fs)
        pc, pn = fk.frame_plain(packed, uni, jit, fs)
        torch.cuda.synchronize()
        diff = (kc - pc).abs()
        max_abs_err = max(max_abs_err, float(diff.max()))
        kn, pn = kn.cpu().numpy(), pn.cpu().numpy()
        cast_rel = abs(int(kn[0]) - int(pn[0])) / max(int(pn[0]), 1)
        walk_rel = np.abs(kn[1:] - pn[1:]).max() / max(pn[1:].max(), 1)
        print(f"kernel vs plain {w}x{h} K={k}: max abs {float(diff.max()):.3e}, "
              f"mean abs {float(diff.mean()):.3e}; cast {int(kn[0])} vs {int(pn[0])} "
              f"(rel {cast_rel:.2e}); walk counters max rel diff {walk_rel:.2e}")
        if not torch.isfinite(kc).all():
            raise AssertionError("kernel produced non-finite colour")
        if float(diff.mean()) > 1e-4 or cast_rel > 1e-4:
            raise AssertionError(f"frame_kernel disagrees with frame_plain at {w}x{h} K={k}")
        return pn

    compare(*SMALL, torch.from_numpy(halton_jitters(1)).cuda())
    compare(*SMALL, torch.from_numpy(halton_jitters(4)).cuda())

    # 5-6. the main path through the Renderer's entry points
    fk.LAUNCHES.clear()
    t0 = time.perf_counter()
    img = renderer.make_fn(statics)(params)
    torch.cuda.synchronize()
    print(f"main path: make_fn {W}x{H} first frame {time.perf_counter() - t0:.3f} s")
    img_np = img.cpu().numpy()
    if img_np.shape != (H, W, 3) or not np.isfinite(img_np).all():
        raise AssertionError(f"frame shape {img_np.shape} or non-finite pixels")
    ref = np.load(GOLDEN)
    got = img_np.reshape(H // 4, 4, W // 4, 4, 3).mean(axis=(1, 3))
    err = np.abs(got - ref)
    mean_err = float(err.mean())
    off_share = float((err.max(axis=-1) > 0.02).mean())
    print(f"golden gate: mean err {mean_err:.6f} (limit 0.005), "
          f"off pixels (>0.02) {off_share:.4%} (limit 1%)")
    if mean_err > 0.005 or off_share > 0.01:
        raise AssertionError("golden gate failed against tests/golden/bench_which0.npy")

    prog = renderer.make_progressive_fn(linear, PROG_K)(params)
    single = renderer.make_fn(linear)
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
    launches = fk.LAUNCHES["frame_kernel"]
    print(f"main path launches: frame_kernel {launches}")
    if launches < 1:
        raise AssertionError("the main path never launched frame_kernel")

    # 7. timing at the main path's shapes
    fs = fk.FrameSettings(width=W, height=H)
    one = torch.zeros((1, 2), dtype=torch.float32, device="cuda")
    batch = torch.from_numpy(halton_jitters(BATCH_K)).cuda()
    kernel_t = cuda_times(lambda: fk.frame_kernel(packed, uni, one, fs), TIMED)
    ms = float(np.median(kernel_t))
    batch_t = [t / BATCH_K for t in cuda_times(lambda: fk.frame_kernel(packed, uni, batch, fs), 5)]
    plain_t = cuda_times(lambda: fk.frame_plain(packed, uni, one, fs), 2)
    plain_ms = float(np.median(plain_t))
    frame = renderer.make_fn(statics)
    e2e_t = host_times(lambda: frame(params), TIMED)
    e2e_ms = float(np.median(e2e_t))
    pn = compare(W, H, one)  # the main path's frame: its counts give the bound
    pops = int(sum(pn[1::3]))
    tris = int(sum(pn[3::3]))
    ops = pops * OPS_PER_POP + tris * OPS_PER_TRI
    nbytes = sum(t.numel() * t.element_size() for t in
                 (packed.node_boxes, packed.node_meta, packed.leaves, packed.env, uni)) \
        + W * H * 3 * 4
    bound_ms = max(ops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if ops / PEAK_F32 >= nbytes / PEAK_BYTES else "bytes"
    potential = W * H * 6
    print(f"timing on {card}:")
    ms_batch = float(np.median(batch_t))
    print(f"  frame_kernel {W}x{H} K=1 (CUDA events): {summary(kernel_t)}; "
          f"{potential / ms / 1e3:.1f} Mrays/s potential, {cast / ms / 1e3:.1f} Mrays/s cast")
    print(f"  make_fn {W}x{H} end to end (host clock, synchronized per frame): "
          f"{summary(e2e_t)}; kernel median {ms / e2e_ms:.1%} of it")
    print(f"  frame_kernel {W}x{H} K={BATCH_K}: per sample {summary(batch_t)}; "
          f"{potential / ms_batch / 1e3:.1f} Mrays/s potential")
    print(f"  frame_plain {W}x{H} K=1: {summary(plain_t)}")
    print(f"  bound: {pops} node pops, {tris} triangle tests -> {ops:.4g} ops "
          f"({ops / PEAK_F32 * 1e3:.4f} ms), {nbytes} bytes "
          f"({nbytes / PEAK_BYTES * 1e3:.4f} ms): {bound_ms:.4f} ms, by {bound_by}")

    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "frame_kernel",
        "route": "cuda",
        "source": "shader_ray_tpu_torch/csrc/frame_kernel.cu",
        "replaces": "shader_ray_tpu/ops/pallas/kernel_mega.py:57",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
