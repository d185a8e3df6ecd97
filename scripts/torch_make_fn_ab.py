#!/usr/bin/env python3
"""``make_fn`` end to end for two checkouts of the port, in turns on one
card.

    python3 scripts/torch_make_fn_ab.py archive/parent . --pairs 10

Each run is a fresh process that imports ``shader_ray_tpu_torch`` and
``chip_smoke`` from one checkout, builds the bench configuration
(``chip_smoke.bench_inputs``: 69k triangles, ``procedural_sky(2048)``,
1024x768, which=0), packs it and times ``--frames`` calls of the
Renderer's ``make_fn`` on the host clock with a device synchronize each
frame, after 20 warm-up frames; it prints the median.  The pairs
alternate which checkout runs first.  The script prints every run's
median, the pairs each side won, the median of each side's medians with
its quartiles, and the card's name and power limit.  Each checkout
builds its kernels into its own ``shader_ray_tpu_torch/build/`` on its
first run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.ops.render import RenderStatics
data, sky, params = chip_smoke.bench_inputs()
fn = Renderer(data, sky).make_fn(RenderStatics(width=chip_smoke.W, height=chip_smoke.H))
for _ in range(20):
    fn(params)
torch.cuda.synchronize()
ms = []
for _ in range(int(sys.argv[2])):
    t0 = time.perf_counter()
    fn(params)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"median_ms": float(np.median(ms)), "p95_ms": float(np.percentile(ms, 95))}))
"""


def run(checkout: str, frames: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout), str(frames)],
                          capture_output=True, text=True, timeout=900, cwd=checkout)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    import numpy as np

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("a", help="first checkout (the parent)")
    p.add_argument("b", help="second checkout (the change)")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--frames", type=int, default=200)
    args = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    med = {args.a: [], args.b: []}
    wins = {args.a: 0, args.b: 0}
    for i in range(args.pairs):
        order = (args.a, args.b) if i % 2 == 0 else (args.b, args.a)
        got = {}
        for checkout in order:
            t0 = time.perf_counter()
            got[checkout] = run(checkout, args.frames)
            med[checkout].append(got[checkout]["median_ms"])
            print(f"pair {i + 1}, {checkout}: make_fn median {got[checkout]['median_ms']:.4f} ms, "
                  f"p95 {got[checkout]['p95_ms']:.4f} ms, n={args.frames} (run {time.perf_counter() - t0:.1f} s)",
                  flush=True)
        a, b = got[args.a]["median_ms"], got[args.b]["median_ms"]
        if a != b:
            wins[args.a if a < b else args.b] += 1
    for checkout, ms in med.items():
        q1, q2, q3 = np.percentile(ms, [25, 50, 75])
        print(f"{checkout}: median of {len(ms)} run medians {q2:.4f} ms (quartiles {q1:.4f}, {q3:.4f}); "
              f"pairs won {wins[checkout]} of {args.pairs}")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
