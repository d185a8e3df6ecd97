"""The readings the correctness limits are set from, on the card:

    python -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 5

builds the cell's set-up once, then for each seed serves a window of the
cell's own traffic at its own sizes and checks it as a run does, with
the control beside it: the reference computed in TF32 in the program's
place (reference.py), compared to the float64 reference at the same
frames and pixels.  One JSON line a seed: the program's numbers and the
control's.  A limit lies above every program reading and below the
smallest control reading (PERF.md gives both).
"""

from __future__ import annotations

import argparse
import json

import torch

from portbench import harness, spec


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device")
        return 2
    session = harness.Session(cell.config, torch.device("cuda", 0))
    for seed in (int(s) for s in args.seeds.split(",")):
        run, gestures, kept = harness.run_window(session, cell.name, cell.traffic, seed,
                                                 args.seconds, False)
        harness.check(session, run, gestures, kept, seed, control=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "requests": run.requests,
                          "program": run.check, "control": run.control}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
