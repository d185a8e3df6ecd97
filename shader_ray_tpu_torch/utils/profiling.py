"""Spans and device traces (counterpart of shader_ray_tpu/utils/profiling.py).

``span(name)`` brackets one step of the program at a layer boundary (the
App's input and copy, the Renderer's frame function and its steps, the
set-up's scene build, pack, upload and kernel library, each kernel
launch).  It has three states:

* off (the default): ``span`` returns one shared null context; it reads
  no clock and allocates nothing;
* while a ``torch.profiler`` records (``device_trace``, or any
  ``torch.profiler.profile``): a ``record_function`` range, in the same
  trace and on the same clock as the card's kernels and copies;
* inside ``recording()``: the span's name, the frame id, the enclosing
  span and its ``perf_counter_ns`` start and end go into the yielded
  ``Recorder``'s list in memory, nothing written during the run;
  ``Recorder.totals`` sums them by name.

Both the profiler and a recorder may be on at once.  The spans of one
frame share a frame id, set by the App (``set_frame``): the number of the
frame drawn, and for a drag the number of the frame it leads to.  A
recorder expects the spans of one thread.

``SPANS`` names every span the program opens at a layer boundary, with
what it covers.  Besides them each kernel wrapper opens a span around its
launch, named after the kernel (``frame_kernel``, ``frame_kernel_mt``,
``trace_wide``, ``trace_wide_mt``, ``trace_binary``, ``env_sample``).
"""

from __future__ import annotations

import contextlib
import os
import time
import types
from typing import NamedTuple

import torch

SPANS = {
    "app.drag": "App.drag: the trackball, camera and light matrices",
    "app.frame_params": "App.frame_params: the frame's uniforms as host tensors",
    "app.copy": "App.draw_frame / render_progressive: the frame to the host (from a card one "
                "stream-ordered copy into pinned memory, and the wait on the card; from the CPU "
                ".cpu().numpy())",
    "engine.frame": "a Renderer's frame function, every route",
    "engine.uniforms": "the fused routes' host block of uniforms and single-frame jitter, filled",
    "engine.jitter": "the (1, 2) jitter table and its copy to the device (unfused, which = 5)",
    "engine.finish": "the tonemap and gamma of a linear frame",
    "frame_kernel.call": "ops/frame_kernel.frame_kernel: the block check, the launch cache's "
                         "lookup, allocations, the launch",
    "world.bvh": "make_world: the BVH build, ':<route>' appended (object, object-native, sbvh, "
                 "sbvh-native), reinsertion inside",
    "world.shader_data": "get_shader_data: the flatten of a numpy build and the reference tables",
    "renderer.pack": "Renderer.__init__: the host pack of the scene and the env pyramid",
    "pack.collapse": "pack_scene_wide: the 8-wide collapse, ':<route>' appended (sah-native, sah, "
                     "greedy)",
    "renderer.upload": "Renderer.__init__: the packed tables to the device",
    "kernels.build": "ops/_build.build: an nvcc run, ':<library>' appended",
    "kernels.load": "ops/_build.library: the library's ctypes load, ':<library>' appended",
}

_NULL = contextlib.nullcontext()
# torch keeps whether a profiler records in this module attribute; a
# torch without it gets a range always
_profiler = (torch.autograd.profiler if hasattr(torch.autograd.profiler, "_is_profiler_enabled")
             else types.SimpleNamespace(_is_profiler_enabled=True))
_recorder: Recorder | None = None
_frame = 0


def set_frame(frame: int) -> None:
    """The frame id the spans opened from now on carry."""
    global _frame
    _frame = frame


class Total(NamedTuple):
    count: int
    total_s: float
    self_s: float      # total_s less the time of the spans opened inside


class Recorder:
    """Spans in memory: ``spans`` holds a (name, frame, parent, t0, t1)
    tuple a span, in the order they opened; ``parent`` is the index of
    the enclosing span (None at the top), ``t0`` and ``t1`` are
    ``time.perf_counter_ns`` readings (``t1`` None while it is open)."""

    def __init__(self) -> None:
        self.spans: list[tuple] = []
        self._open: list[int] = []

    def _enter(self, name: str) -> int:
        i = len(self.spans)
        self.spans.append((name, _frame, self._open[-1] if self._open else None,
                           time.perf_counter_ns(), None))
        self._open.append(i)
        return i

    def _exit(self, i: int) -> None:
        t1 = time.perf_counter_ns()
        name, frame, parent, t0, _ = self.spans[i]
        self.spans[i] = (name, frame, parent, t0, t1)
        self._open.remove(i)

    def totals(self, since: int = 0) -> dict[str, Total]:
        """Count, total and self seconds by name of the closed spans from
        index ``since`` on."""
        count: dict[str, int] = {}
        total: dict[str, int] = {}
        inner: dict[str, int] = {}
        spans = self.spans
        for name, _, parent, t0, t1 in spans[since:]:
            if t1 is None:
                continue
            count[name] = count.get(name, 0) + 1
            total[name] = total.get(name, 0) + t1 - t0
            if parent is not None and parent >= since and spans[parent][4] is not None:
                outer = spans[parent][0]
                inner[outer] = inner.get(outer, 0) + t1 - t0
        return {k: Total(n, total[k] * 1e-9, (total[k] - inner.get(k, 0)) * 1e-9)
                for k, n in count.items()}


class _Span:
    __slots__ = ("name", "range", "rec", "i")

    def __init__(self, name: str, profiling: bool, rec: Recorder | None):
        self.name = name
        self.range = torch.profiler.record_function(name) if profiling else None
        self.rec = rec

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.rec is not None:
            self.i = self.rec._enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec._exit(self.i)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one step named ``name`` (module
    docstring): a shared null context when neither a profiler nor a
    recorder is on."""
    if _recorder is None and not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, _profiler._is_profiler_enabled, _recorder)


@contextlib.contextmanager
def recording():
    """Record the spans opened inside into a ``Recorder`` held in memory;
    yields it.  Recordings do not nest: the outer one resumes after."""
    global _recorder
    outer, _recorder = _recorder, Recorder()
    try:
        yield _recorder
    finally:
        _recorder = outer


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a ``torch.profiler`` trace of the enclosed work (the host,
    and the card where there is one) and write it to
    ``logdir/trace-<pid>-<ns>.json`` in Chrome's trace format (view it in
    Perfetto or chrome://tracing).  Each span is a ``user_annotation``
    range in it.  The card's work is waited for before the trace ends.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
