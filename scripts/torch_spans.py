#!/usr/bin/env python3
"""The port's own spans (utils/profiling.span) in a portbench cell, on
the card.

    python3 scripts/torch_spans.py --workload bunny69k.interactive --seed 1 --seconds 20

It builds the cell as portbench does (``harness.Session``, then
``harness.run_window`` untraced) with the program's recorder on
(``profiling.recording``) from before the set-up to the end of the
window, and the Renderer behind portbench's host-clock proxy
(``harness.Timed``), so ``engine.frame`` can be held to the proxy's
time on the same frames.  Then, on a fresh App of the same session, it
records ``--trace-seconds`` of requests with the profiler (the mix's
``trace_seconds`` by default) and charges each gap in the card's
activity to the innermost program span open at the time.

It prints one JSON object as the last line of stdout:

* ``setup``: each span's count, total and self seconds in set-up (the
  frames of the mix's warm-up requests and before: the scene build's
  ``world.bvh:<route>`` and ``world.shader_data``, ``renderer.pack``,
  ``renderer.upload``, ``kernels.build:<library>``,
  ``kernels.load:<library>``);
* ``build``: the World's build counts: its route, the triangles, the
  references R, the spatial splits taken, the nodes and the leaves;
* ``window``: each span's total and self milliseconds a request over the
  untraced window, ``requests``, ``frame_ms_mean`` and the proxy's
  ``engine_host_ms`` over every frame beside ``engine.frame``'s;
* ``plans``: over set-up and the untraced window, the frame kernel's
  launch cache entries built (``ops/_build.PLANS``), its launches, those
  made through an entry (``through_a_plan``), and their share;
* ``traced``: the profiled window's seconds, requests, device
  operations (kernels, copies, memsets) a request, the card's idle
  share, and its idle seconds by the innermost program span
  (``outside`` where none is open);
* ``device``: the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
REQUEST = "torch_spans.request"
ENGINE = ("engine.", "frame_kernel")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def charge(gaps, ranges) -> dict[str, float]:
    """Seconds of ``gaps`` ((start, end) in µs, sorted, disjoint) by the
    name of the innermost of ``ranges`` ((start, end, name), nested) open
    at the time; ``outside`` where none is."""
    # closes before opens at one time; of two opening together the longer first
    marks = sorted([(a, 1, a - b, i) for i, (a, b, _) in enumerate(ranges)]
                   + [(b, 0, 0, i) for i, (_, b, _) in enumerate(ranges)])
    out: dict[str, float] = {}
    stack: list[int] = []
    gi, now = 0, gaps[0][0] if gaps else 0.0

    def upto(t):
        nonlocal gi
        while gi < len(gaps) and gaps[gi][1] <= now:
            gi += 1
        k = gi
        while k < len(gaps) and gaps[k][0] < t:
            a, b = max(gaps[k][0], now), min(gaps[k][1], t)
            if b > a:
                name = ranges[stack[-1]][2] if stack else "outside"
                out[name] = out.get(name, 0.0) + (b - a) * 1e-6
            k += 1

    for t, opening, _, i in marks:
        upto(t)
        now = max(now, t)
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    if gaps:
        upto(gaps[-1][1])
    return out


def reduce_trace(events: list[dict]) -> dict | None:
    """The traced window (first request's start to last request's end) of
    complete trace events: device operations started in it, the card's
    idle share and its idle seconds by the innermost program span."""
    events = [e for e in events if e.get("ph") == "X"]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
              if e.get("cat") == "user_annotation"]
    requests = [(a, b) for a, b, n in ranges if n == REQUEST]
    if not requests:
        return None
    w0, w1 = min(a for a, _ in requests), max(b for _, b in requests)
    device, ops = [], 0
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a = float(e["ts"])
            ops += w0 <= a < w1
            a, b = max(a, w0), min(a + float(e["dur"]), w1)
            if b > a:
                device.append((a, b))
    gaps, t = [], w0
    for a, b in _union(device):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    idle = charge(gaps, [r for r in ranges if r[2] != REQUEST])
    window_s = (w1 - w0) * 1e-6
    return {"window_s": window_s, "requests": len(requests),
            "device_ops_per_request": ops / len(requests),
            "idle_pct": 100.0 * sum(b - a for a, b in gaps) * 1e-6 / window_s,
            "idle_in_engine_pct": 100.0 * sum(s for k, s in idle.items() if k.startswith(ENGINE))
            / window_s,
            "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1]))}


def split(rec, warmup: int):
    """The recorder's spans of set-up (frame id up to ``warmup``) and of
    the window, each summed by name."""
    from shader_ray_tpu_torch.utils.profiling import Recorder

    parts = (Recorder(), Recorder())
    index: dict[int, tuple[int, int]] = {}   # recorder index -> (part, index in it)
    for i, (name, frame, parent, t0, t1) in enumerate(rec.spans):
        p = int(frame > warmup)
        at = index.get(parent) if parent is not None else None
        index[i] = (p, len(parts[p].spans))
        parts[p].spans.append((name, frame, at[1] if at and at[0] == p else None, t0, t1))
    return parts[0].totals(), parts[1].totals()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="scripts/torch_spans.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--trace-seconds", type=float, default=None)
    p.add_argument("--device", default="cuda", help="cpu runs the plain versions (slow)")
    args = p.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("SRT_")]:
        del os.environ[k]

    import torch

    from portbench import harness, spec, traffic
    from portbench.run import power_limit_w
    from portbench.trace import Spans, profiler
    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.utils import profiling

    cell = spec.find_cell(args.workload)
    mix = cell.traffic
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_spans: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.zeros(1, device=device)
    timed = None

    def wrap(renderer):
        nonlocal timed
        timed = harness.Timed(renderer, Spans())
        timed.counting = True
        return timed

    plans = _build.PLANS
    counts0 = dict(_build.LAUNCHES), dict(plans)
    with profiling.recording() as rec:
        session = harness.Session(cell.config, device, wrap=wrap)
        run, _, _ = harness.run_window(session, cell.name, mix, args.seed, args.seconds, False)
    frame_kernels = [k for k in _build.LAUNCHES if k.startswith("frame_kernel")]
    launches = sum(_build.LAUNCHES[k] - counts0[0].get(k, 0) for k in frame_kernels)
    planned = sum(plans.get(k, 0) - counts0[1].get(k, 0) for k in frame_kernels)
    setup, window = split(rec, int(mix["warmup"]))
    n = run.requests
    frame = rec.totals().get("engine.frame")
    out = {
        "cell": cell.name, "seed": args.seed,
        "setup": {k: t._asdict() for k, t in sorted(setup.items())},
        "build": {"triangles": session.world.triangle_count,
                  **dataclasses.asdict(session.world.counts)},
        "window": {"requests": n, "frame_ms_mean": 1e3 * run.window_s / n,
                   "engine_host_ms_all_frames": 1e3 * timed.host_s / max(timed.calls, 1),
                   "engine_frame_ms_all_frames": 1e3 * frame.total_s / frame.count if frame else None,
                   "ms_a_request": {k: [1e3 * t.total_s / n, 1e3 * t.self_s / n]
                                    for k, t in sorted(window.items())}},
        "plans": {"built": plans.get("built", 0) - counts0[1].get("built", 0),
                  "frame_kernel_launches": launches, "through_a_plan": planned,
                  "share": planned / launches if launches else None},
    }

    # the profiled window, on a fresh App (the profiler's first start, which
    # takes seconds, around one request before it)
    session.renderer = timed._renderer
    app = session.app(mix, session.renderer)
    gestures = traffic.Gestures(args.seed, mix["views"], mix["span_px"])
    with profiler():
        app.drag(*gestures.next())
        traffic.request(app, mix)
    session.sync()
    seconds = args.trace_seconds if args.trace_seconds is not None else float(mix["trace_seconds"])
    prof = profiler()
    with prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with torch.profiler.record_function(REQUEST):
                app.drag(*gestures.next())
                traffic.request(app, mix)
        session.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    out["traced"] = reduce_trace(events["traceEvents"] if isinstance(events, dict) else events)
    out["device"] = ({"name": torch.cuda.get_device_name(device), "power_limit_w": power_limit_w()}
                     if device.type == "cuda" else {"name": "cpu"})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
