"""Tracing and profiling helpers (counterpart of
shader_ray_tpu/utils/profiling.py).

The reference brackets its load phases with wall-clock prints
(world.cpp:56, 95-129) and estimates frames per second (ray.cpp:713-716).
Here: the same phase timers, a frame meter that reports ms and Mrays/s,
and ``device_trace``, a ``torch.profiler`` trace of the host and the card
written to a directory (each kernel launch is a range named after its
wrapper, ops/_build.traced).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch


@contextlib.contextmanager
def phase(name: str, file=sys.stderr):
    """Wall-clock span printed like the reference's load-phase logs."""
    t0 = time.monotonic()
    yield
    print(f"{name}: {time.monotonic() - t0:f} seconds", file=file)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a ``torch.profiler`` trace of the enclosed work (the host,
    and the card where there is one) and write it to
    ``logdir/trace-<pid>-<ns>.json`` in Chrome's trace format (view it in
    Perfetto or chrome://tracing).  The card's work is waited for before
    the trace ends.  Yields the profiler."""
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


class FrameMeter:
    """Per-frame timing and throughput (the reference's fps estimator,
    ray.cpp:713-716, with the Mrays/s of W*H*rays_per_pixel).  Time
    a device frame with a synchronize before ``stop``."""

    def __init__(self, width: int, height: int, rays_per_pixel: int = 6):
        self.rays = width * height * rays_per_pixel
        self._t0: float | None = None
        self.last_ms: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> tuple[float, float]:
        """Returns (frame_ms, mrays_per_s)."""
        dt = time.perf_counter() - self._t0
        self.last_ms = dt * 1e3
        return self.last_ms, self.rays / dt / 1e6
