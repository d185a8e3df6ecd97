"""The general traffic generator: one user in a closed loop, who drags the
model in the viewer and waits for each frame.

A mix is a data file ``traffic/<name>.json`` of parameters:

* ``request``: ``"frame"`` (``App.render()``, one tonemapped frame on
  the host) or ``"progressive"`` (``App.render_progressive(samples)``,
  one launch of ``samples`` Halton-jittered samples, tonemapped once);
* ``samples``, ``width``, ``height``, ``which`` (the viewer's debug mode);
* ``views`` and ``span_px`` [x, y]: each request starts with one object
  drag, from where the last one ended to one of ``views`` points evenly
  spaced on the segment from -span to +span pixels of the first press,
  visiting every point once a cycle, each cycle in an order drawn from
  the seed.  Every seed so sees the same views in another order, and a
  window the same work.  With y = 0 the user turns the model about the
  vertical axis, as on a turntable; then the views are exact (rotations
  about one axis commute);
* ``warmup``: requests made in set-up before the window;
* ``trace_seconds``: how much of a traced run's window the profiler sees;
* ``check``: how many of the window's frames (``frames``) and pixels of
  each (``pixels``) the reference checks.
"""

from __future__ import annotations

import numpy as np


class Gestures:
    """The seed's endless sequence of drags, (dx, dy) in pixels, and the
    ones handed out so far (``history``)."""

    def __init__(self, seed: int, views: int, span_px):
        self._rng = np.random.default_rng([seed, 1])
        self._points = np.linspace(-1.0, 1.0, int(views))[:, None] * np.asarray(span_px, np.float64)
        self._cycle: list[int] = []
        self._at = np.zeros(2)
        self.history: list[tuple[float, float]] = []

    def next(self) -> tuple[float, float]:
        if not self._cycle:
            self._cycle = list(self._rng.permutation(len(self._points)))
        to = self._points[self._cycle.pop()]
        dx, dy = to - self._at
        self._at = to
        self.history.append((float(dx), float(dy)))
        return self.history[-1]


def samples(mix: dict) -> int:
    """Samples a pixel that one request renders."""
    return int(mix["samples"]) if mix["request"] == "progressive" else 1


def request(app, mix: dict):
    """Serve one request's frame through the viewer: the (H, W, 3)
    tonemapped array on the host."""
    if mix["request"] == "progressive":
        return app.render_progressive(int(mix["samples"]))
    if mix["request"] == "frame":
        return app.render()
    raise ValueError(f"unknown request kind {mix['request']!r}")
