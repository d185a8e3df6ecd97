"""One run of a cell: set-up, the measured window, and the check.

Set-up builds what the program serves from the configuration's file
alone: the scene (scene.py), the program's ``Config`` written out in the
file (``program``; no environment variable, autotune or scene cache
reaches it), the scene build (``TriangleSet``, ``make_world``,
``get_shader_data``), the ``engine.Renderer`` on the device and, for each
window, a fresh ``app.driver.App`` over them, as the command line builds
it, set up by the configuration's ``view``: its material and diffuse
colour by the ``m`` and ``d`` keys, then its ``drags`` in order, each
the ``l`` or ``o`` key and a drag by (x * width, y * height) pixels, then
``o``.  The mix's ``warmup`` requests run first; the first of them loads
the kernel library (built once per checkout into the program's own build
directory).

The window is a closed loop of one user: drag, then the request's frame
on the host (traffic.py), until ``seconds`` have passed; the last
request ends the window.  A traced run records the last
``trace_seconds`` of it with the profiler and the benchmark's spans,
and, before that, the host seconds inside the Renderer's frame function
through a thin proxy of the Renderer (``Timed``); after the window it
reads the walk counters of one frame at the last view (``counters``).
Every run counts the kernel launches and launch plans of the window
(``ops/_build.LAUNCHES`` and ``PLANS``, read just before and just after
it).

The check (``check``) takes a sample of the window's frames drawn from
the seed (a reservoir: every frame is as likely to be kept), a sample of
pixels of each, and holds them to the plain reference (reference.py) at
the view the viewer had after that frame's drag.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import costs, reference, scene, spec, traffic
from portbench.trace import Spans, Summary, profiler, summarize


class Timed:
    """The Renderer as the App sees it, its frame functions wrapped in the
    ``pb.frame_fn`` span; while ``counting``, each call's host seconds add
    to ``host_s`` and ``calls``."""

    def __init__(self, renderer, spans: Spans):
        self._renderer = renderer
        self._spans = spans
        self.counting = False
        self.host_s = 0.0
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._renderer, name)

    def make_fn(self, statics):
        return self._timed(self._renderer.make_fn(statics))

    def make_progressive_fn(self, statics, samples, reduce_sum=False):
        return self._timed(self._renderer.make_progressive_fn(statics, samples, reduce_sum))

    def _timed(self, fn):
        def call(params):
            with self._spans("pb.frame_fn"):
                t0 = time.perf_counter()
                out = fn(params)
                dt = time.perf_counter() - t0
            if self.counting:
                self.host_s += dt
                self.calls += 1
            return out

        return call


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn by ``rng``."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.items = size, rng, []

    def offer(self, i: int, item) -> None:
        """Offer the ``i``-th item (0-based)."""
        if len(self.items) < self.size:
            self.items.append((i, item))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.size:
            self.items[j] = (i, item)


@dataclass
class Run:
    """What a run measured, as the metric readers find it."""

    cell: str
    config: dict
    traffic: dict
    triangles: int
    setup_s: float = 0.0
    scene_build_s: float = 0.0
    renderer_init_s: float = 0.0
    window_s: float = 0.0
    requests: int = 0
    samples: int = 1                    # samples a pixel of one request
    trace: Summary | None = None
    engine_host_s: float = 0.0
    engine_calls: int = 0
    node_pops: int | None = None        # the stats fn's node pops of one sample
    rays_cast: int | None = None
    # the stats fn's rows summed over tiles: "rays_cast" and
    # "<phase>.node_pops", "<phase>.leaf_visits", "<phase>.tri_tests"
    counters: dict[str, int] = field(default_factory=dict)
    # the window's launches by kernel (_build.LAUNCHES) and, as
    # "plans.<key>", its launch plans (_build.PLANS); only those that moved
    launches: dict[str, int] = field(default_factory=dict)
    work: reference.Work | None = None  # the reference walk's work on the checked rays
    checked_rays: int = 0               # primary rays the check traced
    check: dict = field(default_factory=dict)
    control: dict = field(default_factory=dict)

    @property
    def size(self) -> tuple[int, int]:
        return int(self.traffic["width"]), int(self.traffic["height"])

    def bound_s_per_sample(self) -> float | None:
        """The least time one full-image sample could take on the card, by
        the reference walk's counted work scaled from the checked rays to
        the image (costs.py)."""
        if not self.work or not self.checked_rays:
            return None
        w, h = self.size
        ops = costs.walk_ops(*self.work) * (w * h) / self.checked_rays
        moved = costs.launch_bytes(self.triangles, w, h, self.samples) / self.samples
        return costs.bound_seconds(ops, moved)


class Session:
    """The scene, the program's configuration, world and Renderer of one
    configuration, built once (the set-up a run times)."""

    def __init__(self, config: dict, device, wrap=None, root: Path = spec.ROOT):
        from shader_ray_tpu_torch.config import Config
        from shader_ray_tpu_torch.engine import Renderer
        from shader_ray_tpu_torch.models.triangle_set import TriangleSet
        from shader_ray_tpu_torch.models.world import get_shader_data, make_world

        self.config = config
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.tri, self.sky = scene.make_scene(config["scene"], root)
        self.cfg = Config(**config["program"]).validate()
        t1 = time.perf_counter()
        self.world = make_world(TriangleSet.from_arrays(self.tri), self.cfg)
        data = get_shader_data(self.world, self.cfg)
        t2 = time.perf_counter()
        renderer = Renderer(data, self.sky, self.cfg, device=self.device)
        self.renderer = wrap(renderer) if wrap else renderer
        # seconds of each set-up phase; run_window adds "warmup"
        self.phases = {"scene": t1 - t0, "build": t2 - t1, "renderer": time.perf_counter() - t2}
        self._reference = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def app(self, mix: dict, renderer):
        from shader_ray_tpu_torch.app.driver import App

        view = self.config["view"]
        app = App(self.world, renderer, self.cfg, int(mix["width"]), int(mix["height"]))
        for _ in range(int(view["material"])):
            app.key("m")
        for _ in range(int(view["diffuse_color"])):
            app.key("d")
        for d in view.get("drags", ()):
            app.key(reference.DRAG_KEYS[d["target"]])
            app.drag(float(d["x"]) * app.width, float(d["y"]) * app.height)
        app.key("o")   # the traffic's drags turn the object
        app.which = int(mix["which"])
        return app

    def close(self) -> None:
        """Free the program's state on the device."""
        self.renderer = self.world = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self) -> reference.Reference:
        """The float64 reference of the scene, built once."""
        if self._reference is None:
            self._reference = reference.Reference(self.tri, self.sky, self.device)
        return self._reference


def run_window(session: Session, cell: str, mix: dict, seed: int, seconds: float, trace: bool,
               t_start: float | None = None) -> tuple[Run, traffic.Gestures, Reservoir]:
    """Warm up, then serve the mix for ``seconds``: the Run, the gestures
    handed out and the frames kept for the check."""
    from shader_ray_tpu_torch.ops.frame_kernel import stats_phases
    from shader_ray_tpu_torch.ops.render import RenderStatics

    spans = Spans()
    timed = Timed(session.renderer, spans) if trace else None
    t0 = time.perf_counter()
    app = session.app(mix, timed or session.renderer)
    gestures = traffic.Gestures(seed, mix["views"], mix["span_px"])
    run = Run(cell, session.config, mix, len(session.tri), samples=traffic.samples(mix),
              scene_build_s=session.phases["build"])
    warmup = int(mix["warmup"])
    for i in range(warmup):
        # a traced run starts the profiler once in set-up, around the last
        # warm-up request: its first start takes seconds (CUPTI)
        with profiler() if trace and i == warmup - 1 else contextlib.nullcontext():
            app.drag(*gestures.next())
            traffic.request(app, mix)
        if i == 0:
            run.renderer_init_s = session.phases["renderer"] + time.perf_counter() - t0
    session.sync()
    session.phases["warmup"] = time.perf_counter() - t0
    kept = Reservoir(int(mix["check"]["frames"]), np.random.default_rng([seed, 2]))
    prof = None
    trace_from = seconds - float(mix["trace_seconds"]) if trace else float("inf")
    before = launch_counts()
    t_win = time.perf_counter()
    if t_start is not None:
        run.setup_s = t_win - t_start
    if timed is not None:
        timed.counting = trace_from > 0
    n, now = 0, t_win
    while True:
        if prof is None and now - t_win >= trace_from:
            timed.counting = False
            prof = profiler()
            prof.__enter__()
            spans.on = True
        with spans("pb.request"):
            with spans("pb.drag"):
                app.drag(*gestures.next())
            with spans("pb.render"):
                frame = traffic.request(app, mix)
        kept.offer(n, frame)
        n += 1
        now = time.perf_counter()
        if now - t_win >= seconds:
            break
    run.window_s = now - t_win
    run.requests = n
    run.launches = {k: v - before.get(k, 0) for k, v in launch_counts().items()
                    if v != before.get(k, 0)}
    if prof is not None:
        session.sync()
        prof.__exit__(None, None, None)
        spans.on = False
        run.trace = summarize(prof)
        run.engine_host_s, run.engine_calls = timed.host_s, timed.calls
        statics = RenderStatics.from_config(session.cfg, width=int(mix["width"]),
                                            height=int(mix["height"]), which=0)
        stats = session.renderer.make_stats_fn(statics)
        if stats is not None:
            phases = stats_phases(statics.bounce_count, statics.cast_shadows, statics.enable_diffuse)
            run.counters = counters(stats(app.frame_params()).cpu(), phases)
            run.rays_cast = run.counters["rays_cast"]
            run.node_pops = sum(run.counters[f"{p}.node_pops"] for p in phases)
    return run, gestures, kept


def launch_counts() -> dict[str, int]:
    """The program's launch counters now: ``ops/_build.LAUNCHES`` by
    kernel, ``_build.PLANS`` as "plans.<key>"."""
    from shader_ray_tpu_torch.ops import _build

    return {**_build.LAUNCHES, **{f"plans.{k}": v for k, v in _build.PLANS.items()}}


COUNTER_COLUMNS = ("node_pops", "leaf_visits", "tri_tests")


def counters(rows, phases: list[str]) -> dict[str, int]:
    """The stats fn's (n_tiles, 1 + 3 * phases) counter rows summed over
    tiles: column 0 as "rays_cast", columns 1 + 3p + c as
    "<phases[p]>.<COUNTER_COLUMNS[c]>"."""
    if rows.shape[1] != 1 + len(COUNTER_COLUMNS) * len(phases):
        raise ValueError(f"counter rows of {rows.shape[1]} columns for phases {phases}")
    sums = [int(x) for x in rows.sum(0)]
    out = {"rays_cast": sums[0]}
    for p, phase in enumerate(phases):
        for c, name in enumerate(COUNTER_COLUMNS):
            out[f"{phase}.{name}"] = sums[1 + len(COUNTER_COLUMNS) * p + c]
    return out


def check(session: Session, run: Run, gestures: traffic.Gestures, kept: Reservoir, seed: int,
          control: bool = False) -> None:
    """Hold the kept frames to the reference (module docstring): fills
    ``run.check`` with the compared numbers, ``run.work`` and
    ``run.checked_rays``; with ``control``, ``run.control`` with the same
    numbers of the control (the reference in TF32) in the program's place."""
    mix, prog = run.traffic, run.config["program"]
    view = run.config["view"]
    w, h = run.size
    warm = int(mix["warmup"])
    items = sorted(kept.items, key=lambda x: x[0])
    views = reference.replay_views(session.tri, w, h, prog["fov_degrees"], view["material"],
                                   view["diffuse_color"], gestures.history,
                                   [warm + i for i, _ in items], view.get("drags", ()))
    jit = (reference.halton_jitters(run.samples) if mix["request"] == "progressive"
           else np.zeros((1, 2), np.float32))
    ref = session.reference()
    ctl = reference.Reference(session.tri, session.sky, session.device, "tf32") if control else None
    rng = np.random.default_rng([seed, 3])
    n_pix = min(int(mix["check"]["pixels"]), w * h)
    pixels = [rng.choice(w * h, size=n_pix, replace=False) for _ in items]
    frames = [views[warm + i] for i, _ in items]
    shading = (prog["bounce_count"], prog["cast_shadows"])
    want, work = ref.render(frames, w, h, pixels, jit, *shading)
    got = np.concatenate([np.asarray(f, np.float64).reshape(-1, 3)[p]
                          for (_, f), p in zip(items, pixels)])
    run.work = work
    run.checked_rays = len(items) * n_pix * len(jit)
    run.check = compare(np.abs(got - want))
    if ctl is not None:
        run.control = compare(np.abs(ctl.render(frames, w, h, pixels, jit, *shading)[0] - want))


OFF = 0.02    # a pixel is off where a channel of its tonemapped colour is off by more
FINE = 1e-4   # ... and finely off by more than this: the program's rounding stays far below


def compare(err: np.ndarray) -> dict[str, float]:
    """The compared numbers of (n, 3) absolute errors of tonemapped
    pixels: ``mean_err`` over pixels and channels, ``off_share`` and
    ``fine_share`` the shares of pixels off by more than OFF and FINE in a
    channel, ``max_err``.  A pixel that is not finite counts as infinitely
    off."""
    err = np.where(np.isfinite(err), err, np.inf)
    worst = err.max(axis=1)
    return {"mean_err": float(err.mean()), "off_share": float((worst > OFF).mean()),
            "fine_share": float((worst > FINE).mean()), "max_err": float(worst.max())}


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Whether every number that has a limit is within it (a NaN is not)."""
    return all(numbers[k] <= lim for k, lim in limits.items())
