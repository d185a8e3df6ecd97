"""The benchmark's scenes, made by the benchmark itself and handed to both
the program and the reference: a radially perturbed UV sphere at a
target triangle count (a stand-in for a scanned mesh such as the
Stanford Bunny) and a procedural lat-long sky (a stand-in for an HDR
environment such as pisa.hdr).

A frozen, vectorised copy of ``shader_ray_tpu_torch.models.fixtures``'
``uv_sphere``, ``bunny_class_scene`` and ``procedural_sky``: the same
float32 arrays for the same arguments (test_portbench_scene.py holds them
equal), without the per-triangle Python loop, so a million-triangle mesh
takes about a second.  The mesh does not depend on the seed: it is the
deployment's data set, the seed draws only the traffic.

A configuration's ``scene.generator`` names the mesh's generator:
``bunny_class`` is this module's (``GENERATORS``); any other name is the
file ``scenes/<generator>.py`` of this package, whose
``generate(scene: dict) -> np.ndarray`` gets the configuration's whole
``scene`` entry and returns (T, 3, 3) float32 positions.  A generator
file is part of the yardstick: it imports numpy and nothing of the
program, and it sets the mesh from the entry alone, never from the seed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.spec import ROOT, module


def uv_sphere(lat: int, lon: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit UV sphere -> (tri_pos (T, 3, 3), tri_norm (T, 3, 3)) float32,
    T = 2 * lat * lon - 2 * lon (the degenerate cap triangles left out),
    in the order of the loop over rows i and columns j: (p00, p10, p01)
    unless i is the first row, then (p01, p10, p11) unless i is the last."""
    theta = np.linspace(0.0, np.pi, lat + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, lon + 1)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    n = np.stack(
        [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], axis=-1
    ).astype(np.float32)
    p = np.zeros(3, np.float32) + 1.0 * n

    def tris(a):
        corner = lambda di, dj: a[di:di + lat, dj:dj + lon]
        upper = np.stack([corner(0, 0), corner(1, 0), corner(0, 1)], axis=2)
        lower = np.stack([corner(0, 1), corner(1, 0), corner(1, 1)], axis=2)
        both = np.stack([upper, lower], axis=2)            # (lat, lon, 2, 3, 3)
        keep = np.ones((lat, lon, 2), bool)
        keep[0, :, 0] = False
        keep[lat - 1, :, 1] = False
        return both[keep]

    return np.ascontiguousarray(tris(p)), np.ascontiguousarray(tris(n))


def bunny_class_scene(target_tris: int) -> np.ndarray:
    """(T, 3, 3) float32 positions of a UV sphere of about
    ``target_tris`` triangles, displaced along its normals by three sine
    waves, so the tree sees uneven density."""
    lon = int(np.sqrt(target_tris))
    lat = max(4, (target_tris // (2 * lon)) + 1)
    pos, nrm = uv_sphere(lat, lon)
    center = pos.mean(axis=(0, 1))
    rel = pos - center
    disp = (
        0.12 * np.sin(3.0 * rel[..., 0:1] * np.pi)
        + 0.08 * np.sin(5.0 * rel[..., 1:2] * np.pi + 1.3)
        + 0.05 * np.sin(7.0 * rel[..., 2:3] * np.pi + 2.1)
    )
    return (pos + nrm * disp).astype(np.float32)


def procedural_sky(width: int) -> np.ndarray:
    """(width / 2, width, 3) float32 lat-long sky, row 0 the +y pole: a
    gradient brightest at the horizon and a sun disk 50 times as bright."""
    height = width // 2
    v = np.linspace(0.0, 1.0, height)[:, None]
    u = np.linspace(0.0, 1.0, width)[None, :]
    y = np.cos(v * np.pi)
    horizon = np.exp(-np.abs(y) * 3.0)
    sky = np.zeros((height, width, 3), dtype=np.float32)
    sky[..., 0] = 0.25 + 0.55 * horizon + 0.15 * np.maximum(y, 0.0)
    sky[..., 1] = 0.35 + 0.45 * horizon + 0.2 * np.maximum(y, 0.0)
    sky[..., 2] = 0.6 + 0.3 * horizon + 0.3 * np.maximum(y, 0.0)
    du = np.minimum(np.abs(u - 0.25), 1.0 - np.abs(u - 0.25))
    dv = v - 0.3
    d2 = du * du + dv * dv
    sun = 50.0 * np.exp(-d2 / (2 * 0.012 ** 2))
    sky += sun[..., None] * np.array([1.0, 0.95, 0.8], dtype=np.float32)
    return sky.astype(np.float32)


GENERATORS = {"bunny_class": bunny_class_scene}


def make_scene(spec: dict, root: Path = ROOT) -> tuple[np.ndarray, np.ndarray]:
    """(triangles (T, 3, 3), sky (H, W, 3)) of a configuration's
    ``scene`` entry: ``{"generator": ..., "target_tris": ..., "sky_width": ...}``
    and whatever else its generator reads; a generator file is looked up
    in the checkout ``root`` (module docstring).  Raises KeyError naming
    the missing file of an unknown generator, ValueError on triangles
    that are not (T, 3, 3) float32."""
    name = spec["generator"]
    if name in GENERATORS:
        tri = GENERATORS[name](int(spec["target_tris"]))
    else:
        tri = module("scenes", name, root).generate(spec)
        if not (isinstance(tri, np.ndarray) and tri.dtype == np.float32 and tri.ndim == 3
                and tri.shape[1:] == (3, 3) and len(tri)):
            raise ValueError(f"scenes/{name}.py: generate() must return (T, 3, 3) float32, "
                             f"got {type(tri).__name__} {getattr(tri, 'dtype', '')} "
                             f"{getattr(tri, 'shape', '')}")
    return tri, procedural_sky(int(spec["sky_width"]))
