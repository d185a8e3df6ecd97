#!/usr/bin/env python3
"""The frame kernel of two checkouts of the port, in turns on one card,
at their default launch.

    python3 scripts/torch_frame_ab.py archive/parent . --pairs 3

Each run is a fresh process that imports ``shader_ray_tpu_torch`` and
``chip_smoke`` from one checkout, builds the bench configuration
(``chip_smoke.bench_inputs``: 69k triangles, ``procedural_sky(2048)``,
1024x768), packs it and times the frame kernel with CUDA events: which=0
at K=1 (n=100) and a sample of K=64 (n=10), which=1 aniso 4 at K=1
(n=100) and the given-rays form of the which=0 rays (n=100); it prints
the medians with the raygen which=0 instantiation's registers and blocks
an SM.  The pairs alternate which checkout runs first.  The script prints
every run, the median of each side's medians, and the card's name and
power limit.  Each checkout builds its kernels into its own
``shader_ray_tpu_torch/build/`` on its first run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.ops import frame_kernel as fk
from shader_ray_tpu_torch.ops.engine_frame import halton_jitters, pack_uniforms
data, sky, params = chip_smoke.bench_inputs()
packed = Renderer(data, sky).packed
uni = pack_uniforms(params).cuda()
one = torch.zeros((1, 2), dtype=torch.float32, device="cuda")
batch = torch.from_numpy(halton_jitters(64)).cuda()
fs = fk.FrameSettings(width=chip_smoke.W, height=chip_smoke.H)
given = fk.raygen_rays(uni, one, fs)
runs = {
    "which0_k1": (lambda: fk.frame_kernel(packed, uni, one, fs), 100, 1),
    "which0_k64_per_sample": (lambda: fk.frame_kernel(packed, uni, batch, fs), 10, 64),
    "which1_aniso4_k1": (lambda: fk.frame_kernel(packed, uni, one, fs._replace(which=1, env_aniso=4)),
                         100, 1),
    "given_k1": (lambda: fk.frame_kernel(packed, uni, None, fs, rays=given), 100, 1),
}
out = {k: float(np.median(chip_smoke.cuda_times(fn, n))) / k_ for k, (fn, n, k_) in runs.items()}
info = fk.launch_info(packed.stack_depth)
out.update(registers=info["registers"], blocks_per_sm=info["blocks_per_sm"])
print(json.dumps(out))
"""


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout)],
                          capture_output=True, text=True, timeout=900, cwd=checkout,
                          env={**os.environ, "SRT_NATIVE": "require"})
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    import numpy as np

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("a", help="first checkout (the parent)")
    p.add_argument("b", help="second checkout (the change)")
    p.add_argument("--pairs", type=int, default=3)
    args = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    got = {args.a: [], args.b: []}
    for i in range(args.pairs):
        for checkout in (args.a, args.b) if i % 2 == 0 else (args.b, args.a):
            got[checkout].append(run(checkout))
            print(f"pair {i + 1}, {checkout}: {json.dumps(got[checkout][-1])}", flush=True)
    for key in got[args.a][0]:
        a = float(np.median([r[key] for r in got[args.a]]))
        b = float(np.median([r[key] for r in got[args.b]]))
        print(f"{key}: {args.a} {a:.4f}, {args.b} {b:.4f} ({b / a - 1:+.2%}) on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
