"""ctypes bindings for the native C++ scene builder (counterpart of
shader_ray_tpu/native/__init__.py).

``csrc/host/libscene.cpp`` is a byte copy of the reference's
``native/libscene.cpp``: binned-SAH BVH build + flatten with the hit/miss
links, and the trisrc, OBJ and Radiance HDR readers.  It is built with
g++ and the reference's flags at first use into the git-ignored
``shader_ray_tpu_torch/build/``, under a cache tag over the source and
the flags (as ``ops/_build.py`` tags the CUDA libraries), one build at a
time across processes.  Its BVH is bit-identical to the numpy builder
(models/bvh.py + models/flatten.py); its parsers agree with the Python
readers (tests/test_torch_native.py).  ``Config.use_native`` routes to
it (models/world.py, trisrc.py, obj.py, background.py):

* ``auto``    -- use it when it builds and loads; numpy otherwise;
* ``never``   -- numpy only;
* ``require`` -- raise (``unavailable``) when it cannot be built or loaded.

It is host code, not a device kernel: nothing here runs on the card.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from shader_ray_tpu_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "host" / "libscene.cpp"
# -ffp-contract=off pins FMA contraction so the SAH bin math stays
# bit-identical to the numpy builder (the reference's flags)
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")
BUILD_TIMEOUT = 300  # seconds


def _path():
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libscene-{digest.hexdigest()[:12]}.so"


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native scene builder builds with g++")
    return cxx


def build() -> str:
    """Build the library unless it is built; returns its path.  Raises
    RuntimeError when g++ is missing or fails."""
    so = _path()
    if so.exists():
        return str(so)
    cxx = _compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libscene.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if so.exists():
            return str(so)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=BUILD_TIMEOUT)
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"g++ took over {BUILD_TIMEOUT} s building libscene") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building libscene:\n{proc.stderr}")
        os.replace(tmp, so)
    return str(so)


@functools.cache
def _load() -> tuple[ctypes.CDLL | None, str]:
    """(the library with its C signatures set, "") or (None, why not)."""
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError) as e:
        return None, str(e)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i32, i64, vp, cp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
    signatures = {
        "srt_bvh_build": (vp, [f32p, f32p, f32p, i32, i32, i32, ctypes.c_float, ctypes.c_float,
                               ctypes.POINTER(i32), ctypes.POINTER(i32), i32p]),
        "srt_bvh_fill": (i32, [vp, f32p, f32p, i32p, i32p, i32p, i32p, i32p]),
        "srt_bvh_leaf_count": (i32, [vp]),
        "srt_bvh_free": (None, [vp]),
        "srt_trisrc_count": (i64, [cp]),
        "srt_trisrc_parse": (i64, [cp, ctypes.c_double, ctypes.c_double, i32, f32p, f32p, f32p]),
        "srt_obj_count": (i64, [cp]),
        "srt_obj_parse": (i64, [cp, f32p, f32p]),
        "srt_hdr_size": (i32, [cp, ctypes.POINTER(i32), ctypes.POINTER(i32)]),
        "srt_hdr_read": (i32, [cp, f32p]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib, ""


def available() -> bool:
    return _load()[0] is not None


def unavailable() -> RuntimeError:
    """The error ``use_native="require"`` raises, with the build's message."""
    return RuntimeError(f"Config.use_native=require but libscene unavailable: {_load()[1]}")


def wanted(use_native: str) -> bool:
    """Whether a loader with ``Config.use_native`` takes the native path:
    never for ``never``; for ``auto`` when the library loads; for
    ``require`` always, raising when it does not load."""
    if use_native == "never":
        return False
    if available():
        return True
    if use_native == "require":
        raise unavailable()
    return False


def _lib() -> ctypes.CDLL:
    lib = _load()[0]
    if lib is None:
        raise unavailable()
    return lib


def build_flat_bvh(
    tri_boxmin: np.ndarray,
    tri_boxmax: np.ndarray,
    barycenters: np.ndarray,
    leaf_max: int = 10,
    max_depth: int = 30,
    ctrav: float = 1.0,
    cisec: float = 4.0,
):
    """Native BVH build + flatten: (FlatBVH, order, leaf count), equal to
    models.bvh.make_bvh + models.flatten.flatten_bvh."""
    from shader_ray_tpu_torch.models.flatten import FlatBVH

    lib = _lib()
    T = int(barycenters.shape[0])
    bmin = np.ascontiguousarray(tri_boxmin, np.float32)
    bmax = np.ascontiguousarray(tri_boxmax, np.float32)
    bary = np.ascontiguousarray(barycenters, np.float32)
    order = np.empty(T, np.int32)
    node_count = ctypes.c_int32()
    root = ctypes.c_int32()
    handle = lib.srt_bvh_build(bmin, bmax, bary, T, leaf_max, max_depth, ctypes.c_float(ctrav),
                               ctypes.c_float(cisec), ctypes.byref(node_count), ctypes.byref(root),
                               order)
    try:
        if root.value < 0:
            raise RuntimeError("native BVH build failed (index assignment)")
        n = node_count.value
        boxmin = np.empty((n, 3), np.float32)
        boxmax = np.empty((n, 3), np.float32)
        start = np.empty(n, np.int32)
        count = np.empty(n, np.int32)
        children = np.empty((n, 2), np.int32)
        axis = np.empty(n, np.int32)
        hitmiss = np.empty((8, n, 2), np.int32)
        rc = lib.srt_bvh_fill(handle, boxmin, boxmax, start, count, children.reshape(-1), axis,
                              hitmiss.reshape(-1))
        if rc != 0:
            raise RuntimeError(f"native BVH fill failed (code {rc})")
        leaf_count = lib.srt_bvh_leaf_count(handle)
    finally:
        lib.srt_bvh_free(handle)
    flat = FlatBVH(boxmin=boxmin, boxmax=boxmax, start=start, count=count, children=children,
                   axis=axis, hitmiss=hitmiss, root=int(root.value))
    return flat, order, int(leaf_count)


def parse_trisrc_file(path: str, geometry_scale: float, screen_gamma: float,
                      colors_are_linear: bool):
    """Native trisrc parser (reference trisrc-support.cpp:43-104): (pos,
    nrm, col), each (T, 3, 3) f32.  Raises ValueError on malformed input
    (the Python parser's contract)."""
    lib = _lib()
    bpath = os.fsencode(path)
    T = lib.srt_trisrc_count(bpath)
    if T == -1:
        raise FileNotFoundError(path)
    if T < 0:
        raise ValueError(f"malformed trisrc file: {path}")
    pos, nrm, col = (np.empty((T, 9), np.float32) for _ in range(3))
    rc = lib.srt_trisrc_parse(bpath, float(geometry_scale), float(screen_gamma),
                              1 if colors_are_linear else 0, pos.reshape(-1), nrm.reshape(-1),
                              col.reshape(-1))
    if rc != T:
        raise ValueError(f"malformed trisrc file: {path}")
    return pos.reshape(T, 3, 3), nrm.reshape(T, 3, 3), col.reshape(T, 3, 3)


def parse_obj_file(path: str):
    """Native OBJ parser (reference obj-support.cpp:226-350): (pos, nrm),
    each (T, 3, 3) f32."""
    lib = _lib()
    bpath = os.fsencode(path)
    T = lib.srt_obj_count(bpath)
    if T == -1:
        raise FileNotFoundError(path)
    if T < 0:
        raise ValueError(f"malformed OBJ file: {path}")
    pos, nrm = np.empty((T, 9), np.float32), np.empty((T, 9), np.float32)
    rc = lib.srt_obj_parse(bpath, pos.reshape(-1), nrm.reshape(-1))
    if rc != T:
        raise ValueError(f"malformed OBJ file: {path}")
    return pos.reshape(T, 3, 3), nrm.reshape(T, 3, 3)


def read_hdr_file(path: str) -> np.ndarray:
    """Native Radiance RGBE reader: (H, W, 3) f32; raises ValueError on
    malformed files (the Python reader's contract)."""
    lib = _lib()
    bpath = os.fsencode(path)
    H, W = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.srt_hdr_size(bpath, ctypes.byref(H), ctypes.byref(W))
    if rc == -1:
        raise FileNotFoundError(path)
    if rc == -2:
        raise ValueError(f"{path}: not a Radiance HDR file")
    if rc != 0:
        raise ValueError(f"{path}: unsupported HDR orientation")
    out = np.empty((H.value, W.value, 3), np.float32)
    rc = lib.srt_hdr_read(bpath, out.reshape(-1))
    if rc != 0:
        raise ValueError(f"{path}: corrupt HDR pixel data (code {rc})")
    return out
