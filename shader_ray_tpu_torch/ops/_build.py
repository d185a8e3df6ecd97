"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, built by nvcc for sm_90a at first use into the git-ignored
``shader_ray_tpu_torch/build/`` and loaded with ctypes.  The cache tag
hashes the source, every header it includes (transitively, quote
includes under ``csrc/``) and the compiler flags, so an edit of a shared
header never loads a stale library.  Nothing is built when a module is
imported.

``LAUNCHES`` counts launches per kernel name, process-wide: a wrapper
adds one where it launches its kernel and nowhere else, so a run can
set a count to 0, drive a path and read how often the kernel really ran.
``traced`` names a launch in a profiler's trace.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header it includes, in first-seen
    order."""
    seen: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())]
    return seen


def _paths(name: str) -> tuple[Path, Path]:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources_of(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    so = BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"
    return so, so.with_suffix(".log")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the kernels build with the CUDA toolkit")
    return nvcc


def build(names: list[str] | tuple[str, ...]) -> None:
    """Build the libraries of ``names`` that are not built yet, one nvcc
    process each, all started together.  Raises if any fails."""
    jobs = []
    for name in names:
        so, log = _paths(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((name, so, log, tmp, proc))
    failed = []
    for name, so, log, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name}.cu:\n{err}")
            continue
        log.write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def library(name: str) -> tuple[ctypes.CDLL, str]:
    """Build (once per source hash) and load ``csrc/<name>.cu``.
    Returns (library, the compiler's resource report)."""
    build([name])
    so, log = _paths(name)
    return ctypes.CDLL(str(so)), log.read_text() if log.exists() else ""


def one_device(where: str, tensors: dict[str, torch.Tensor]) -> torch.device:
    """The single device all ``tensors`` lie on; raises otherwise."""
    devices = {x.device for x in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{where}: tensors on several devices {devices}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{where}: unsupported device {device}")
    return device


def check(where: str, name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape``
    (None = any extent)."""
    if x.dtype != dtype or not x.is_contiguous() or x.dim() != len(shape) or any(
        s is not None and s != n for s, n in zip(shape, x.shape)
    ):
        raise ValueError(
            f"{where}: {name} must be contiguous {dtype} of shape {shape}, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


INFO_KEYS = ("registers", "static_smem", "local_bytes", "dynamic_smem", "blocks_per_sm",
             "threads")


def launch_info(name: str, entry: str, *args: int,
                keys: tuple[str, ...] = INFO_KEYS) -> dict[str, int]:
    """A kernel's launch resources on the current card, from the C entry
    ``entry(*args, int* info)`` of library ``name``, which fills ``keys``
    in order: registers a thread, static shared bytes a block, local
    bytes a thread, dynamic shared bytes a block, resident blocks an SM,
    threads a block, then any of the kernel's own."""
    fn = getattr(library(name)[0], entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * len(keys))()
    err = fn(*args, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return dict(zip(keys, info))


# cudaGetErrorString of the errors a launch of these kernels can return
CUDA_ERRORS = {
    1: "invalid argument",
    2: "out of memory",
    9: "invalid configuration argument",
    98: "invalid device function",
    209: "no kernel image is available for execution on the device",
    700: "an illegal memory access was encountered",
    701: "too many resources requested for launch",
}


def launched(name: str, err: int) -> None:
    """Raise on a refused launch, else count it."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({CUDA_ERRORS.get(err, 'see cudaGetErrorString')})")
    LAUNCHES[name] += 1


def traced(name: str):
    """A ``record_function`` range named after the kernel around its
    launch while a profiler records (utils/profiling.device_trace), so a
    trace names the wrapper; nothing otherwise."""
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", True):
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
