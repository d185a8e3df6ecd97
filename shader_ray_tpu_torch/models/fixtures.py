"""Procedural scene fixtures: the bench's bunny-class mesh and HDR-like
sky (stand-ins for bunny.trisrc and pisa.hdr), the UV sphere, the
occlusion-heavy ridged terrain, and one triangle, a quad and a box
(shader_ray_tpu/models/fixtures.py; the same arrays for the same
arguments)."""

from __future__ import annotations

import numpy as np


def single_triangle() -> np.ndarray:
    """One triangle facing +z, centered at the origin, (1, 3, 3)."""
    return np.array(
        [[[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.0, 0.5, 0.0]]], dtype=np.float32
    )


def quad(z: float = 0.0, half: float = 0.5) -> np.ndarray:
    """Two triangles forming a square in the plane z, (2, 3, 3)."""
    return np.array(
        [
            [[-half, -half, z], [half, -half, z], [half, half, z]],
            [[-half, -half, z], [half, half, z], [-half, half, z]],
        ],
        dtype=np.float32,
    )


def box(center=(0.0, 0.0, 0.0), half=0.5) -> np.ndarray:
    """Axis-aligned cube as 12 triangles, outward CCW winding, (12, 3, 3)."""
    c = np.asarray(center, dtype=np.float32)
    h = float(half)
    # the 8 corners: x is bit 2 of the index, y bit 1, z bit 0
    s = np.array(
        [[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)],
        dtype=np.float32,
    ) + c
    faces = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    tris = []
    for a, b, cc, d in faces:
        tris.append([s[a], s[b], s[cc]])
        tris.append([s[a], s[cc], s[d]])
    return np.asarray(tris, dtype=np.float32)


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


def terrain_scene(target_tris: int = 69000) -> tuple[np.ndarray, None]:
    """An occlusion-heavy stand-in: a ridged heightfield over [-1, 1]^2
    (2 n^2 triangles, n = sqrt(target / 2)) whose V valleys self-shadow
    under a grazing light, so shadow rays hit real occluders.  Normals
    are left to the TriangleSet (flat face normals)."""
    n = max(8, int(np.sqrt(target_tris / 2.0)))
    xs = np.linspace(-1.0, 1.0, n + 1)
    ys = np.linspace(-1.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    # abs-sine ridges make the sharp valleys
    Z = (
        0.30 * np.abs(np.sin(3.1 * np.pi * X) * np.sin(2.7 * np.pi * Y))
        + 0.18 * np.abs(np.sin(6.3 * np.pi * X + 1.1))
        + 0.12 * np.abs(np.sin(5.7 * np.pi * Y + 2.3))
        + 0.06 * np.sin(11.0 * np.pi * X) * np.sin(13.0 * np.pi * Y)
    )
    P = np.stack([X, Y, Z], axis=-1).astype(np.float32)  # (n+1, n+1, 3)
    tris = []
    for i in range(n):
        for j in range(n):
            p00, p01 = P[i, j], P[i, j + 1]
            p10, p11 = P[i + 1, j], P[i + 1, j + 1]
            tris.append([p00, p10, p01])
            tris.append([p01, p10, p11])
    return np.asarray(tris, dtype=np.float32), None
