"""Per-scene autotune of the frame kernel's launch shape (counterpart of
shader_ray_tpu/utils/autotune.py).

The reference tunes its TPU kernel's schedule first of all through
``prog_tile`` with ``jitter_pack``: which pixels and samples the lanes of
one kernel program cover.  On the card the matching choice is which
pixels a block covers and which a warp covers: ``Config.frame_tile``
(tiles 8, 16, 32 or 64 pixels wide, 256 pixels a block) and
``Config.frame_warp`` (a warp on rows of the tile, or on an 8 x 4 brick
of it).  Both are launch arguments of the one frame kernel, so a
candidate costs no build, only its measurement.  The shipped default
(16 x 16, rows) is listed first in each stage, so it is always measured.

The search is the reference's, letter for letter: an exact-space cache
hit returns without measuring; otherwise a warm start from the newest
winner of a prior space, then an iterated greedy descent over the stages
(at most 3 passes, stopping when a pass moves nothing), with candidate
tags normalised over every knob of the space (defaults from the base
config) and failed candidates kept out of later passes.  A search in
which no candidate was measured persists nothing.  Winners are written
atomically to ``tune-<key>-<hash>.json`` in ``default_cache_dir()``, and
to ``<repo>/tunes/`` only under ``SRT_TUNE_REPO=1``; both are read.  A
record names the device it was measured on (``torch.cuda.
get_device_name``, or ``"cpu"``) in its hash and its ``statics_tag``, and
its knobs are checked against this package's ``Config``, so the TPU
records in ``tunes/`` never apply here.

A candidate is timed as ``bench.py`` times a batch: one warm call of
``make_progressive_fn(statics, samples, reduce_sum=True)``, then the host
clock around each call, which ends in ``.item()`` (the scalar read-back
waits for the card); the median over ``samples``.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from shader_ray_tpu_torch.utils.cache import default_cache_dir

# knob groups, tried as a greedy coordinate descent: each stage keeps the
# best assignment found so far and varies one group.  Stage lists start
# with the shipped default so the baseline is always measured.
DEFAULT_SPACE: list[list[dict]] = [
    # the tile's width (its height is 256 / width): which pixels share a
    # block, and so its compacted walk queues and its L1
    [
        {"frame_tile": 16},
        {"frame_tile": 32},
        {"frame_tile": 8},
        {"frame_tile": 64},
    ],
    # which pixels share a warp: a row segment of the tile, or an 8 x 4
    # brick (the same map as rows at width 8; tags dedup by knob values)
    [
        {"frame_warp": "rows"},
        {"frame_warp": "bricks"},
    ],
]


def _device_kind(device) -> str:
    """The name a tune record gives its device: the card's name, or
    ``"cpu"``.  ``None`` is the current card when there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _space_key(statics, samples: int, space, device=None) -> str:
    """Cache key hash over everything that shapes the measurement."""
    payload = json.dumps(
        {
            "statics": tuple(statics),
            "samples": samples,
            "space": space,
            "device": _device_kind(device),
        },
        sort_keys=True,
        default=str,
    )
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


def _statics_tag(statics, device=None) -> str:
    """Space-independent identity of a measurement: the render statics and
    the device.  Persisted verbatim in each tune record, so a tune stays
    findable after the search space is edited (the space is part of
    ``_space_key``)."""
    return json.dumps(
        {"statics": tuple(statics), "device": _device_kind(device)},
        sort_keys=True,
        default=str,
    )


def _tune_path(key: str, h: str) -> str:
    return os.path.join(default_cache_dir(), f"tune-{key}-{h}.json")


def _repo_tune_dir() -> str | None:
    """Committed tune store: ``<repo>/tunes/``; None when the package is
    installed without the repository checkout."""
    d = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "tunes",
    )
    return d if os.path.isdir(d) else None


def _repo_tune_path(key: str, h: str) -> str | None:
    d = _repo_tune_dir()
    return os.path.join(d, f"tune-{key}-{h}.json") if d else None


def load_tuned(
    key: str, statics, samples: int, space=None, fallback: bool = True, *, device=None,
) -> dict | None:
    """Best knobs from a previous autotune of this (scene, config) on
    ``device`` (default: the current card, else the CPU), or None.  ``key``
    is the scene-cache key.  Looks in the user cache dir first, then the
    repo's store.

    ``fallback=True`` (the apply path, e.g. the bench's BENCH_TUNE=auto):
    when no exact-space-hash file exists, fall back to the newest
    persisted tune for the same (scene key, statics, device) under any
    search space, its knobs filtered to those the current ``Config``
    accepts.  A search (``autotune``) passes fallback=False: a prior-space
    winner must not suppress a fresh search."""
    space = space if space is not None else DEFAULT_SPACE
    h = _space_key(statics, samples, space, device)
    for path in (_tune_path(key, h), _repo_tune_path(key, h)):
        if not path:
            continue
        try:
            with open(path) as f:
                best = json.load(f)["best"]
        except (OSError, ValueError, KeyError):
            continue
        if best:  # an empty best (failed search) is a miss, not a tune
            return best
    if not fallback:
        return None
    tag = _statics_tag(statics, device)
    cands: list[dict] = []
    for d in (default_cache_dir(), _repo_tune_dir()):
        if not d or not os.path.isdir(d):
            continue
        for name in os.listdir(d):
            if not (name.startswith(f"tune-{key}-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(d, name)) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            if rec.get("statics_tag") == tag and rec.get("best"):
                cands.append(rec)
    if not cands:
        return None
    # prefer a tune measured at the same sample count, then the most
    # recent measurement
    same = [r for r in cands if r.get("samples") == samples]
    rec = max(same or cands, key=lambda r: r.get("ts", 0.0))
    return _validate_knobs(rec["best"])


def _validate_knobs(knobs: dict) -> dict | None:
    """Filter a persisted knob set down to values the current ``Config``
    accepts (a knob may be renamed, a value retired).  Returns None when
    nothing survives."""
    from shader_ray_tpu_torch.config import Config

    ok = {}
    for k, v in knobs.items():
        cfg = Config()
        if not hasattr(cfg, k):
            continue
        setattr(cfg, k, v)
        try:
            cfg.validate()
        except Exception:
            continue
        ok[k] = v
    if not ok:
        return None
    cfg = Config()
    for k, v in ok.items():
        setattr(cfg, k, v)
    try:
        cfg.validate()
    except Exception:
        return None
    return ok


def _apply(cfg, knobs: dict):
    cfg2 = copy.copy(cfg)
    for k, v in knobs.items():
        if not hasattr(cfg2, k):
            raise ValueError(f"unknown config knob {k!r}")
        setattr(cfg2, k, v)
    return cfg2


def _time_candidate(renderer, cfg, statics, params, samples, frames):
    """Median seconds a sample of a progressive batch under ``cfg`` (the
    warm call excluded; each call ends in a scalar read-back)."""
    r2 = copy.copy(renderer)  # shares the packed scene; swaps the config
    r2.cfg = cfg  # the Renderer reads its launch knobs from cfg at each call
    pfn = r2.make_progressive_fn(statics, samples, reduce_sum=True)
    pfn(params).item()  # build + warm
    ts = []
    for _ in range(frames):
        t0 = time.perf_counter()
        pfn(params).item()  # the scalar read-back is the fence
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / samples


def autotune(
    renderer,
    statics,
    params,
    samples: int = 32,
    frames: int = 3,
    key: str | None = None,
    space: list[list[dict]] | None = None,
    verbose: bool = True,
    apply: bool = True,
    use_cache: bool = True,
):
    """Greedy per-stage search for the fastest knob tuple on the
    renderer's device.  Returns ``(best_knobs, results)`` where
    ``results`` maps each measured candidate's tag (its knobs as JSON) to
    its ms a sample.

    ``apply=True`` writes the winning knobs onto ``renderer.cfg``, so the
    renderer's next functions launch under them.  ``key`` (the
    scene-cache key) enables persisting and reusing the result across
    runs."""
    from shader_ray_tpu_torch.utils import kerneldiag

    device = renderer.device
    space = space if space is not None else DEFAULT_SPACE
    if key and use_cache:
        # exact-space hits only: a prior-space winner is a seed for a
        # fresh search, never a reason to skip searching the edited space
        best = load_tuned(key, statics, samples, space, fallback=False, device=device)
        if best is not None:
            if verbose:
                print(f"autotune cache hit: {best}", file=sys.stderr)
            if apply:
                for k, v in best.items():
                    setattr(renderer.cfg, k, v)
            return best, {}

    base = renderer.cfg
    best_knobs: dict = {}
    if key and use_cache:
        # warm-start an edited-space search from the newest prior-space
        # winner: its knobs enter every stage's baseline, so the prior
        # optimum is measured and only beaten
        seed = load_tuned(key, statics, samples, space, device=device)
        if seed:
            best_knobs = dict(seed)
            if verbose:
                print(f"autotune seed (prior space): {seed}", file=sys.stderr)
    results: dict[str, float] = {}
    # tags are normalised over every knob the space touches (defaults from
    # the base config), so a candidate that repeats an effective knob set
    # dedups instead of being measured again
    all_keys = sorted({k for st in space for cand in st for k in cand})
    # iterated descent: a single pass sweeps each stage at the knobs chosen
    # so far, which mispicks when stages interact; later passes re-sweep
    # every stage with the current winners applied
    failed: set[str] = set()  # a failing candidate is not tried again
    for pass_n in range(3):
        pass_start = dict(best_knobs)
        for stage in space:
            stage_best, stage_t = None, np.inf
            for cand in stage:
                knobs = {**best_knobs, **cand}
                tag = json.dumps(
                    {k: knobs.get(k, getattr(base, k, None)) for k in all_keys},
                    sort_keys=True,
                )
                if tag in failed:
                    continue
                if tag in results:
                    t = results[tag] / 1e3
                else:
                    try:
                        # candidate failures are expected and handled: no
                        # per-candidate kernel-failure dump
                        with kerneldiag.suppress():
                            t = _time_candidate(
                                renderer, _apply(base, knobs), statics, params, samples, frames,
                            )
                    except Exception as e:  # a refused shape must not sink the search
                        failed.add(tag)
                        if verbose:
                            print(f"autotune: {knobs} failed: {e}", file=sys.stderr)
                        continue
                    results[tag] = round(t * 1e3, 3)
                    if verbose:
                        print(f"autotune[{pass_n}]: {knobs} -> {t * 1e3:.2f} ms/frame",
                              file=sys.stderr)
                if t < stage_t:
                    stage_best, stage_t = cand, t
            if stage_best is not None:
                best_knobs.update(stage_best)
        if best_knobs == pass_start:  # converged: nothing moved
            break
    if verbose:
        print(f"autotune best: {best_knobs}", file=sys.stderr)
    if not results:
        # every candidate failed: persisting the empty result would make
        # every later run cache-hit an empty tune and never search again
        print("autotune: no candidate measured; nothing persisted", file=sys.stderr)
        return best_knobs, results
    if key:
        h = _space_key(statics, samples, space, device)
        payload = {"best": best_knobs, "results_ms": results,
                   "samples": samples, "ts": time.time(),
                   "statics_tag": _statics_tag(statics, device)}
        # the user cache, and the repo's store only under SRT_TUNE_REPO=1:
        # reads consult both, but runs and tests must not write into the
        # checkout
        paths = [_tune_path(key, h)]
        if os.environ.get("SRT_TUNE_REPO"):
            paths.append(_repo_tune_path(key, h))
        for path in paths:
            if not path:
                continue
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(payload, f, indent=1)
                os.replace(tmp, path)
            except OSError:
                pass
    if apply:
        for k, v in best_knobs.items():
            setattr(renderer.cfg, k, v)
    return best_knobs, results
