"""The benchmark's command:

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json on one card and prints, as the last line
of stdout, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; last in it
``check``, each number the check compared beside its limit, which are
also the last lines of stderr.  Without a card, with fewer cards than
the cell asks for, or with the JAX package loaded once the window has
closed, it prints no result and exits 2 or 3.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The ``perf_counter`` reading at which this process started."""
    now = time.perf_counter()
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import harness, spec  # noqa: E402
from portbench.trace import top  # noqa: E402

T_IMPORTED = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "shader_ray_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w() -> float | None:
    """The card's power limit in watts (nvidia-smi), None if unread."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def fail(message: str, code: int) -> int:
    print(f"portbench: {message}", file=sys.stderr)
    return code


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program's own knobs never reach a run: its Config comes from the
    # configuration's file alone
    for k in [k for k in os.environ if k.startswith("SRT_")]:
        del os.environ[k]
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card", 2)
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} present", 2)
    # one process with one host thread a run: steadier host timings
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    torch.zeros(1, device=device)
    t_cuda = time.perf_counter() - t0
    session = harness.Session(cell.config, device)
    run, gestures, kept = harness.run_window(session, cell.name, cell.traffic, args.seed,
                                             args.seconds, bool(args.trace), T_START)
    peak = torch.cuda.max_memory_allocated(device)
    session.close()
    t0 = time.perf_counter()
    harness.check(session, run, gestures, kept, args.seed)
    phases = dict(imports=T_IMPORTED - T_START, cuda=t_cuda, **session.phases)
    print(f"portbench: {cell.name} seed {args.seed}: setup {run.setup_s:.3f} s "
          f"({', '.join(f'{k} {v:.3f}' for k, v in phases.items())}), {run.requests} requests "
          f"in {run.window_s:.3f} s, check {time.perf_counter() - t0:.3f} s, "
          f"max_err {run.check['max_err']!r}", file=sys.stderr)
    correct = harness.verdict(run.check, cell.limits)
    entries = cell.per_layer if args.trace else cell.end_to_end
    result = {
        "correct": correct,
        "attempted": run.requests,
        "failed": 0,
        "metrics": spec.read_metrics(entries, run),
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
                   "memory_peak_bytes": peak, "power_limit_w": power_limit_w()},
    }
    if run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": top(run.trace.device_s),
                               "idle_gaps": top(run.trace.gaps_s)}
    result["check"] = {k: {"value": run.check[k], "limit": lim} for k, lim in cell.limits.items()}
    for k, lim in cell.limits.items():
        print(f"check {k} {run.check[k]!r} limit {lim!r}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        return fail(f"loaded once the window closed: {', '.join(bad)}", 3)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
