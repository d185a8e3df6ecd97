#!/usr/bin/env python3
"""The bench scene's host build for two checkouts of the port, in turns on
one host.

    python3 scripts/torch_build_ab.py archive/parent . --pairs 5

Each run is a fresh process that imports ``shader_ray_tpu_torch`` from one
checkout, makes the bench scene (``bunny_class_scene(69000)``, 68,644
triangles) and times ``get_shader_data(make_world(...))`` on the host clock
through the numpy builder (``use_native="never"``) and the native one
(``"require"``), quiet; where the checkout's ``get_shader_data`` takes
``verbose``, it times the numpy build once more with ``verbose=True`` and
stderr sent to a buffer.  The pairs alternate which checkout runs first.
The script prints every run, the median of each side's runs with its
quartiles, and the card's name and power limit where ``nvidia-smi`` reads
them (the build runs on the host's CPU).  One untimed run of each checkout
first builds its native library into its own ``shader_ray_tpu_torch/build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import contextlib, inspect, io, json, sys, time
sys.path.insert(0, sys.argv[1])
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.fixtures import bunny_class_scene
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
ts = TriangleSet.from_arrays(*bunny_class_scene(69000))
out = {}
for key, way in (("native_s", "require"), ("numpy_s", "never")):
    t0 = time.perf_counter()
    get_shader_data(make_world(ts, Config(use_native=way)))
    out[key] = time.perf_counter() - t0
if "verbose" in inspect.signature(get_shader_data).parameters:
    cfg = Config(use_native="never")
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        get_shader_data(make_world(ts, cfg, verbose=True), cfg, verbose=True)
    out["numpy_verbose_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout)],
                          capture_output=True, text=True, timeout=600, cwd=checkout)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except OSError:
        card = "no nvidia-smi"
    print(f"card: {card}", flush=True)
    for side in ("parent", "change"):  # untimed: builds each checkout's native library
        run(getattr(args, side))
    runs = {"parent": [], "change": []}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            r = run(getattr(args, side))
            runs[side].append(r)
            print(f"pair {i} {side}: " + ", ".join(f"{k} {v:.3f}" for k, v in r.items()), flush=True)
    summary = {}
    for side, rs in runs.items():
        for key in rs[0]:
            v = np.array([r[key] for r in rs])
            summary[f"{side} {key}"] = [float(np.percentile(v, q)) for q in (25, 50, 75)]
            print(f"{side} {key}: median {np.median(v):.3f} s (quartiles {np.percentile(v, 25):.3f}, "
                  f"{np.percentile(v, 75):.3f}), n={len(v)}")
    print(json.dumps({"card": card, "pairs": args.pairs, "quartiles_s": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
