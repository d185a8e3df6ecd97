"""4x4 matrix helpers (host side, numpy).

Standard math convention: ``M @ v`` transforms a column vector, the
same as GLSL ``mat * vec``.  ``mult`` keeps the reference's argument
order (reference vectormath.h:502-517): ``mult(A, B) == B @ A``.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-5  # singularity epsilon, reference vectormath.h:313


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def make_translation(x: float, y: float, z: float) -> np.ndarray:
    """Reference vectormath.h:486-492."""
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = x
    m[1, 3] = y
    m[2, 3] = z
    return m


def make_scale(x: float, y: float, z: float) -> np.ndarray:
    """Reference vectormath.h:494-500."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = x
    m[1, 1] = y
    m[2, 2] = z
    return m


def make_rotation(a: float, x: float, y: float, z: float) -> np.ndarray:
    """Axis-angle (radians, axis (x,y,z)) to rotation matrix, Rodrigues
    form (reference vectormath.h:559-586)."""
    c = np.cos(a)
    s = np.sin(a)
    t = 1.0 - c
    return np.array(
        [
            [t * x * x + c, t * x * y - s * z, t * x * z + s * y, 0.0],
            [t * x * y + s * z, t * y * y + c, t * y * z - s * x, 0.0],
            [t * x * z - s * y, t * y * z + s * x, t * z * z + c, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def mult(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """Compose like the reference's mat4_mult: returns M2 @ M1."""
    return (m2.astype(np.float64) @ m1.astype(np.float64)).astype(np.float32)


def transpose(m: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(m.T)


def invert(m: np.ndarray) -> np.ndarray:
    """Matrix inverse; raises on singular (reference returns -1)."""
    det = np.linalg.det(m.astype(np.float64))
    if abs(det) < _EPS:
        raise np.linalg.LinAlgError("singular matrix in mat4 invert")
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def to_radians(d: float) -> float:
    return float(d) * np.pi / 180.0


def to_degrees(r: float) -> float:
    return float(r) * 180.0 / np.pi


def zero_bottom_row(m: np.ndarray) -> np.ndarray:
    """Zero the projective row (flat indices 3/7/11 in the reference's
    column-major layout, e.g. ray.cpp:114-116,133-139)."""
    r = m.copy()
    r[3, 0:3] = 0.0
    return r


def transform_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """M @ (p, 1), returning xyz. Matches GLSL ``(m * vec4(p,1)).xyz``."""
    return m[:3, :3] @ np.asarray(p, dtype=np.float32) + m[:3, 3]


def transform_vector(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """M @ (v, 0), returning xyz. Matches GLSL ``(m * vec4(v,0)).xyz``."""
    return m[:3, :3] @ np.asarray(v, dtype=np.float32)


def get_rotation(m: np.ndarray) -> np.ndarray:
    """Axis-angle [angle, x, y, z] of a rotation matrix (reference
    vectormath.h:519-557: trace for the angle, skew part for the axis,
    normalized)."""
    cosine = (m[0, 0] + m[1, 1] + m[2, 2] - 1.0) / 2.0
    cosine = float(np.clip(cosine, -1.0, 1.0))
    r = np.zeros(4, dtype=np.float32)
    r[0] = np.arccos(cosine)
    r[1] = m[2, 1] - m[1, 2]
    r[2] = m[0, 2] - m[2, 0]
    r[3] = m[1, 0] - m[0, 1]
    d = np.sqrt(r[1] * r[1] + r[2] * r[2] + r[3] * r[3])
    if d > 0:
        r[1:] /= d
    return r


def rotation_mult_rotation(rot1: np.ndarray, rot2: np.ndarray) -> np.ndarray:
    """Compose two axis-angle rotations, rot1 then rot2 (reference
    vectormath.h:588-600: both matrices, the reference's reverse-order
    mult, axis-angle of the product)."""
    m1 = make_rotation(rot1[0], rot1[1], rot1[2], rot1[3])
    m2 = make_rotation(rot2[0], rot2[1], rot2[2], rot2[3])
    return get_rotation(mult(m2, m1))
