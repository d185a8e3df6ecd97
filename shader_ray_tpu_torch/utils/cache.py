"""Built-scene cache (counterpart of shader_ray_tpu/utils/cache.py).

The reference parses, builds and flattens the scene on every launch
(world.cpp:124); here the flattened ``SceneData`` is stored as an
``.npz`` keyed by ``models.world.scene_fingerprint`` (the file's bytes and
the build knobs), so a relaunch skips the build.  The directory is
``SRT_CACHE_DIR``, else ``~/.cache/shader_ray_tpu_torch``.  The files
carry their own name prefix and fields, so neither package reads the
other's, even in a shared directory.
"""

from __future__ import annotations

import os
import sys
import time
import zipfile
from typing import Callable

import numpy as np

from shader_ray_tpu_torch.models.world import SceneData

_CACHE_VERSION = 1
_ARRAYS = ("tri_positions", "tri_normals", "node_boxes", "node_objects", "node_children")
_INTS = ("tree_root", "triangle_count", "group_count")


def default_cache_dir() -> str:
    return os.environ.get(
        "SRT_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".cache", "shader_ray_tpu_torch")
    )


def _path(key: str) -> str:
    return os.path.join(default_cache_dir(), f"torch-scene-{key}-v{_CACHE_VERSION}.npz")


def save_scene_data(key: str, data: SceneData) -> str:
    path = _path(key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # a process-unique temporary name: builders of the same key in several
    # processes must not interleave their writes before the rename
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez_compressed(
        tmp,
        **{name: getattr(data, name) for name in _ARRAYS},
        **{name: np.int32(getattr(data, name)) for name in _INTS},
        # an empty marker where the scene has no hit/miss links
        hitmiss=data.hitmiss if data.hitmiss is not None else np.zeros((0, 0, 2), np.int32),
    )
    os.replace(tmp, path)
    return path


def load_scene_data(key: str) -> SceneData | None:
    """The cached SceneData of ``key``, or None where there is none or the
    file cannot be read as one."""
    path = _path(key)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return SceneData(
                **{name: z[name] for name in _ARRAYS},
                **{name: int(z[name]) for name in _INTS},
                hitmiss=z["hitmiss"] if z["hitmiss"].size else None,
            )
    except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile):
        return None


def cached_scene_data(
    key: str, builder: Callable[[], SceneData], verbose: bool = False
) -> SceneData:
    """Load SceneData by cache key, or build and store it."""
    data = load_scene_data(key)
    if data is not None:
        if verbose:
            print(f"scene cache hit: {key}", file=sys.stderr)
        return data
    then = time.monotonic()
    data = builder()
    if verbose:
        print(f"scene compile: {time.monotonic() - then:.2f}s (cache miss: {key})",
              file=sys.stderr)
    try:
        save_scene_data(key, data)
    except OSError:
        pass
    return data
