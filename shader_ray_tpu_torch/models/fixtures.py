"""Procedural scene fixtures: the bench's bunny-class mesh and HDR-like
sky (stand-ins for bunny.trisrc and pisa.hdr), and the UV sphere."""

from __future__ import annotations

import numpy as np


def uv_sphere(
    lat: int = 64, lon: int = 128, radius: float = 1.0, center=(0.0, 0.0, 0.0)
) -> tuple[np.ndarray, np.ndarray]:
    """UV sphere -> (tri_pos (T,3,3), tri_norm (T,3,3)) with smooth
    per-vertex normals.  T = 2 * lat * lon minus the degenerate caps."""
    c = np.asarray(center, dtype=np.float32)
    theta = np.linspace(0.0, np.pi, lat + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, lon + 1)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    n = np.stack(
        [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], axis=-1
    ).astype(np.float32)
    p = c + radius * n

    tris_p = []
    tris_n = []
    for i in range(lat):
        for j in range(lon):
            p00, p01 = p[i, j], p[i, j + 1]
            p10, p11 = p[i + 1, j], p[i + 1, j + 1]
            n00, n01 = n[i, j], n[i, j + 1]
            n10, n11 = n[i + 1, j], n[i + 1, j + 1]
            if i > 0:  # skip the degenerate top-cap triangle
                tris_p.append([p00, p10, p01])
                tris_n.append([n00, n10, n01])
            if i < lat - 1:
                tris_p.append([p01, p10, p11])
                tris_n.append([n01, n10, n11])
    return (
        np.asarray(tris_p, dtype=np.float32),
        np.asarray(tris_n, dtype=np.float32),
    )


def bunny_class_scene(target_tris: int = 69000) -> tuple[np.ndarray, None]:
    """A radially perturbed UV sphere of roughly bunny triangle count
    (~69k), so the BVH sees non-uniform density.  Normals are left to
    the TriangleSet (flat face normals)."""
    lon = int(np.sqrt(target_tris))
    lat = max(4, (target_tris // (2 * lon)) + 1)
    pos, nrm = uv_sphere(lat=lat, lon=lon)
    center = pos.mean(axis=(0, 1))
    rel = pos - center
    disp = (
        0.12 * np.sin(3.0 * rel[..., 0:1] * np.pi)
        + 0.08 * np.sin(5.0 * rel[..., 1:2] * np.pi + 1.3)
        + 0.05 * np.sin(7.0 * rel[..., 2:3] * np.pi + 2.1)
    )
    pos = pos + nrm * disp
    return pos.astype(np.float32), None


def procedural_sky(width: int = 1024) -> np.ndarray:
    """HDR-like lat-long sky (height = width / 2): gradient + a bright
    sun disk."""
    height = width // 2
    v = np.linspace(0.0, 1.0, height)[:, None]        # 0 = top row
    u = np.linspace(0.0, 1.0, width)[None, :]
    y = np.cos(v * np.pi)                              # top row = +y pole
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
