"""Spans and the device trace of a traced run.

The benchmark's own spans (``Spans``) bracket the calls into the
program's layers: ``pb.request`` around one request, ``pb.drag`` and
``pb.render`` inside it, and ``pb.frame_fn`` (the Renderer's frame
function) inside ``pb.render``.  While the profiler records they are
``record_function`` ranges, on the profiler's clock beside the card's
kernels and copies; otherwise they cost nothing.

``summarize`` reads a ``torch.profiler`` trace (Chrome's format, the
only one that is the same across versions): the traced window (first
request's start to last request's end), the union of device activity in
it, the device time of each kernel or copy by name, and the idle gaps,
each part of a gap charged to what the host was doing then: the
innermost span, with ``pb.render``'s time before its frame function
named ``frame_params`` and after it ``copy``; outside every span
``loop``.  Only the benchmark's own spans decide how a gap is charged.
Every other range in the window (the program's spans,
``utils/profiling.SPANS``, and its kernel wrappers' launch ranges) is
summed by name, in seconds and in count.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from typing import NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("pb.request", "pb.drag", "pb.render", "pb.frame_fn")


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    requests: int                         # requests whose span lies in the window
    device_s: dict[str, float]            # device seconds by kernel or copy name
    gaps_s: dict[str, float]              # idle seconds by what the host was doing
    spans_s: dict[str, float] = {}        # host seconds of the program's ranges by name
    spans_n: dict[str, int] = {}          # ... and their count


class Spans:
    """``span(name)``: a profiler range while ``on``, else nothing."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()


def profiler():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def summarize(prof) -> Summary:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    events = events["traceEvents"] if isinstance(events, dict) else events
    return reduce_events([e for e in events if e.get("ph") == "X"])


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events: list[dict]) -> Summary:
    """The Summary of complete ("X") trace events: ``ts`` and ``dur`` in
    microseconds, ``cat`` and ``name``."""
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
              if e.get("cat") == "user_annotation"]
    spans = [r for r in ranges if r[2] in SPANS]
    requests = [(a, b) for a, b, n in spans if n == "pb.request"]
    if not requests:
        return Summary(0.0, 0.0, 0, {}, {})
    w0, w1 = min(a for a, _ in requests), max(b for _, b in requests)
    spans_s: dict[str, float] = {}
    spans_n: dict[str, int] = {}
    for a, b, n in ranges:
        if n not in SPANS and w0 <= a and b <= w1:
            spans_s[n] = spans_s.get(n, 0.0) + (b - a) * 1e-6
            spans_n[n] = spans_n.get(n, 0) + 1
    device, dev_s = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b > a:
            device.append((a, b))
            dev_s[e["name"]] = dev_s.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _union(device)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    return Summary((w1 - w0) * 1e-6, sum(b - a for a, b in busy) * 1e-6, len(requests), dev_s,
                   _charge(gaps, spans), spans_s, spans_n)


def _charge(gaps, spans) -> dict[str, float]:
    """Idle seconds of ``gaps`` by the innermost span open at the time."""
    marks = sorted([(a, 1, b, n) for a, b, n in spans] + [(b, 0, a, n) for a, b, n in spans],
                   key=lambda m: (m[0], m[1]))
    out: dict[str, float] = {}
    stack: list[list] = []   # [name, frame function seen]
    gi, now = 0, None

    def label():
        if not stack:
            return "loop"
        name, after = stack[-1]
        if name == "pb.render":
            return "copy" if after else "frame_params"
        return name.removeprefix("pb.")

    def charge(t0, t1):
        nonlocal gi
        while gi < len(gaps) and gaps[gi][1] <= t0:
            gi += 1
        k = gi
        while k < len(gaps) and gaps[k][0] < t1:
            a, b = max(gaps[k][0], t0), min(gaps[k][1], t1)
            if b > a:
                out[label()] = out.get(label(), 0.0) + (b - a) * 1e-6
            k += 1

    for t, opening, _, name in marks:
        if now is not None and t > now:
            charge(now, t)
        now = t
        if opening:
            stack.append([name, False])
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == name:
                    del stack[i]
                    break
            if name == "pb.frame_fn" and stack and stack[-1][0] == "pb.render":
                stack[-1][1] = True
    return out


def top(d: dict[str, float], n: int = 10) -> list[list]:
    """The ``n`` largest entries as [name, seconds], largest first."""
    return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def device_seconds(summary: Summary, pattern: str) -> float:
    """Device seconds of the kernels and copies whose name matches the
    regular expression ``pattern``."""
    rx = re.compile(pattern)
    return sum(s for name, s in summary.device_s.items() if rx.search(name))


FRAME_KERNEL = r"(^|\W)frame<"   # the frame kernel's templated __global__ function
COPY_TO_HOST = r"DtoH"


def idle_pct(summary: Summary | None) -> float | None:
    """The share of the traced window with nothing on the card, in %."""
    if summary is None or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
