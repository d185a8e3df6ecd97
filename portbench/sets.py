"""Sets of runs of one cell, for its bounds:

    python -m portbench.sets --workload <cell> --seeds 1,2,3,4,5,6 --sets 2 \\
        --seconds 20 --out chiprun_out/<cell>.jsonl

runs ``python -m portbench`` once a seed, one process after another, the
seeds in the same order in each set, appends each run's result line to
``--out`` and prints, for each metric, each set's median and spread: the
distance between the first and third quartiles (``statistics.quantiles``,
n=4) over the median.  A metric's bound is about five times the widest
spread of any cell, and never under 1% (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys


def spread(values: list[float]) -> float:
    """Interquartile distance over the median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.sets")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    results = []
    for k in range(args.sets):
        for seed in seeds:
            proc = subprocess.run([sys.executable, "-m", "portbench", "--workload", args.workload,
                                   "--seed", str(seed), "--seconds", str(args.seconds),
                                   "--trace", str(args.trace)], capture_output=True, text=True)
            tail = proc.stdout.strip().splitlines()[-1:] if proc.returncode == 0 else []
            line = json.loads(tail[0]) if tail else {"error": proc.stderr[-2000:]}
            line.update(set=k, seed=seed, rc=proc.returncode)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
            results.append(line)
            m = {n: v["value"] for n, v in line.get("metrics", {}).items()}
            print(f"set {k} seed {seed} rc {proc.returncode} correct {line.get('correct')} {m}", flush=True)
    names = sorted({n for r in results for n in r.get("metrics", {})})
    for n in names:
        for k in range(args.sets):
            vals = [r["metrics"][n]["value"] for r in results if r["set"] == k and n in r.get("metrics", {})]
            if len(vals) >= 2:
                print(f"{n} set {k}: median {statistics.median(vals)!r} spread {spread(vals):.5f} "
                      f"n {len(vals)}")
    return 0 if all(r["rc"] == 0 and r.get("correct") for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
