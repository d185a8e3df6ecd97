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


def invert(m: np.ndarray) -> np.ndarray:
    """Matrix inverse; raises on singular (reference returns -1)."""
    det = np.linalg.det(m.astype(np.float64))
    if abs(det) < _EPS:
        raise np.linalg.LinAlgError("singular matrix in mat4 invert")
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def to_radians(d: float) -> float:
    return float(d) * np.pi / 180.0
