"""Kernel-failure diagnostics (counterpart of
shader_ray_tpu/utils/kerneldiag.py; the reference's CheckShaderCompile,
ray.cpp:187-235, dumps the failing program and its info log).

A build or launch failure of a hand-written kernel otherwise surfaces as
an nvcc log or a bare CUDA error number with no record of which kernel
or settings produced it.  ``describe_failure`` renders one screen: the
kernel (the deepest wrapper frame of ops/frame_kernel.py,
ops/trace_kernel.py or ops/env_kernel.py in the traceback), the
``FrameSettings`` or trace settings, the table shapes of the packed
scene, the device, and a hint matched on the error text.  The Renderer
wraps every function it hands out (engine.Renderer._wrap), so each build
and launch failure of a kernel on its paths prints the dump before the
error is re-raised.  ``SRT_KERNEL_DIAG=0`` or a ``suppress()`` scope
silences it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import traceback

_suppressed = 0

# the wrappers that launch a kernel, by function name (the kernel's name)
KERNEL_WRAPPERS = ("frame_kernel", "trace_wide", "trace_binary", "env_sample")


@contextlib.contextmanager
def suppress():
    """Silence reports inside a scope that expects failures and handles
    them itself."""
    global _suppressed
    _suppressed += 1
    try:
        yield
    finally:
        _suppressed -= 1


def _port_frames(exc: BaseException) -> list[tuple[str, str]]:
    """(function, "file:line (function)") of the traceback's frames in
    the port's ops/, outermost first."""
    frames = []
    for f, lineno in traceback.walk_tb(exc.__traceback__):
        path = f.f_code.co_filename.replace("\\", "/")
        if "/shader_ray_tpu_torch/ops/" in path:
            name = f.f_code.co_name
            frames.append((name, f"{os.path.basename(path)}:{lineno} ({name})"))
    return frames


# (substring of the error text, hint); the first match wins
_HINTS = [
    ("nvcc not found", "the CUDA toolkit is missing: the kernels build with nvcc at first use "
                       "(PATH, or /usr/local/cuda/bin/nvcc)"),
    ("nvcc failed", "nvcc refused the kernel source: its error is above; an edit of csrc/ "
                    "or a toolkit without sm_90a support (the kernels need CUDA 12 for Hopper)"),
    ("too many resources requested", "the launch asked for more registers or shared memory a "
                                     "block than the card has: a deeper scene stack "
                                     "(PackedWide.stack_depth) grows the frame kernel's shared "
                                     "stack; compare launch_info() with the card's limits"),
    ("no kernel image", "the library was built for another architecture than this card "
                        "(sm_90a, Hopper): delete shader_ray_tpu_torch/build/ and run on an H100"),
    ("illegal", "the kernel read or wrote out of bounds: the context is lost for this process; "
                "rerun with CUDA_LAUNCH_BLOCKING=1 to stop at the faulting launch, and check "
                "the packed tables with Config.validate_scene"),
    ("out of memory", "device memory exhausted: a smaller frame or progressive batch (the "
                      "which=5 frame holds 25 direction sets of W x H rays)"),
    ("invalid argument", "the kernel's C entry refused its arguments before launching: a "
                         "setting outside its range (bounce_count < 0, more walk phases than "
                         "the counter row holds, an env pyramid it cannot read)"),
]


def _hint(text: str) -> str | None:
    low = text.lower()
    return next((hint for needle, hint in _HINTS if needle in low), None)


def _settings_text(settings) -> str:
    if hasattr(settings, "_asdict"):
        settings = settings._asdict()
    if isinstance(settings, dict):
        return ", ".join(f"{k}={v!r}" for k, v in settings.items())
    return repr(settings)


_KNOBS = ("packet_kernel", "packet_fused", "leaf_isect", "packet_max_steps", "min_contrib",
          "env_base", "env_aniso", "max_leaf_tests", "collapse", "splits", "bvh_opt",
          "use_native", "debug_nans")


def describe_failure(exc: BaseException, cfg=None, packed=None, settings=None,
                     label: str = "frame fn", *, device=None) -> str:
    """One screen on a kernel's build or launch failure."""
    lines = [f"=== kernel failure ({label}) ===",
             f"error: {type(exc).__name__}: {str(exc).strip()[:500]}"]
    frames = _port_frames(exc)
    kernel = next((name for name, _ in reversed(frames) if name in KERNEL_WRAPPERS), None)
    if kernel is not None:
        lines.append(f"kernel: {kernel}" + (f"  (at {frames[-1][1]}, via {frames[0][1]})"
                                           if frames else ""))
    elif frames:
        lines.append(f"at: {frames[-1][1]}  (via {frames[0][1]})")
    if settings is not None:
        lines.append(f"settings: {_settings_text(settings)}")
    if cfg is not None:
        lines.append("config: " + ", ".join(f"{k}={getattr(cfg, k)!r}" for k in _KNOBS
                                            if hasattr(cfg, k)))
    if packed is not None:
        shapes = [f"{type(packed).__name__}:"]
        for name in ("nodes", "leaves", "normals", "tris"):
            arr = getattr(packed, name, None)
            if arr is not None and hasattr(arr, "shape"):
                shapes.append(f"{name}{tuple(arr.shape)}")
        pyramid = getattr(packed, "env_pyramid", None)
        if pyramid is not None:
            shapes.append(f"env{tuple(pyramid.texels.shape)} in {pyramid.n_levels} levels")
        for name in ("isect", "n_wide", "stack_depth", "max_count"):
            v = getattr(packed, name, None)
            if v is not None:
                shapes.append(f"{name}={v}")
        lines.append("scene: " + " ".join(shapes))
    if device is not None:
        lines.append(f"device: {device}")
    hint = _hint(str(exc))
    if hint:
        lines.append(f"hint: {hint}")
    lines.append("=" * 40)
    return "\n".join(lines)


def report_failure(exc: BaseException, cfg=None, packed=None, settings=None,
                   label: str = "frame fn", *, device=None) -> None:
    """Print ``describe_failure`` to stderr unless suppressed
    (``SRT_KERNEL_DIAG=0`` or a ``suppress()`` scope).  Never raises: the
    caller re-raises the real error."""
    if _suppressed or os.environ.get("SRT_KERNEL_DIAG", "1") == "0":
        return
    try:
        print(describe_failure(exc, cfg, packed, settings, label, device=device), file=sys.stderr,
              flush=True)
    except Exception:  # the dump must never mask the real error
        pass
