"""Hardcoded PBR materials table (reference ray.cpp:48-74, "From
Hoffman's notes from S2010"; copy of shader_ray_tpu/app/materials.py).

The selected material globally overrides all object materials
(README.md:16): a metal renders with black diffuse; a dielectric takes
the selected diffuse color (ray.cpp:698-704).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Material(NamedTuple):
    name: str
    specular_color: tuple[float, float, float]  # F0
    metal: bool


# F0 values verbatim from ray.cpp:54-65 (refractives stay commented
# out there and are omitted here too)
MATERIALS: list[Material] = [
    Material("gold", (1.0, 0.71, 0.29), True),
    Material("silver", (0.95, 0.95, 0.88), True),
    Material("copper", (0.95, 0.64, 0.54), True),
    Material("iron", (0.56, 0.57, 0.58), True),
    Material("aluminum", (0.91, 0.92, 0.92), True),
    Material("plastic/glass (low)", (0.03, 0.03, 0.03), False),
    Material("plastic high", (0.05, 0.05, 0.05), False),
]

# ray.cpp:68-73
DIFFUSE_COLORS: list[tuple[float, float, float]] = [
    (1.0, 1.0, 1.0),     # white
    (1.0, 0.5, 0.5),     # reddish
    (0.25, 1.0, 0.25),   # quite green
    (0.5, 0.5, 1.0),     # blueish
]


def resolve_material(
    which_material: int, which_diffuse_color: int
) -> tuple[np.ndarray, np.ndarray]:
    """(specular_color, diffuse_color) for the frame uniforms, applying
    the metal->black-diffuse override (ray.cpp:700-704)."""
    mtl = MATERIALS[which_material % len(MATERIALS)]
    spec = np.asarray(mtl.specular_color, dtype=np.float32)
    if mtl.metal:
        diff = np.zeros(3, dtype=np.float32)
    else:
        diff = np.asarray(
            DIFFUSE_COLORS[which_diffuse_color % len(DIFFUSE_COLORS)],
            dtype=np.float32,
        )
    return spec, diff
