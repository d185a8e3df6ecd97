"""Trackball camera, object/light transforms (reference ray.cpp:76-173;
numpy copy of shader_ray_tpu/app/camera.py).

All matrices follow the reference's inverse-sense convention: the
camera matrix transforms *eye-space rays to world* and the object
matrix transforms *world rays to object space* (comments at
ray.cpp:105-108, 119-123), because the consumer is a ray tracer, not a
rasterizer.
"""

from __future__ import annotations

import numpy as np

from shader_ray_tpu_torch.utils import mat4


def drag_to_rotation(dx: float, dy: float) -> np.ndarray:
    """Mouse delta -> axis-angle [angle, x, y, z] (ray.cpp:76-90).

    Angle = pi * drag distance; axis is the in-plane perpendicular
    (dy, dx, 0).  (The reference scales by 1e4 inside the sqrt against
    float underflow; in float64 that is a no-op.)
    """
    dist = float(np.sqrt(dx * dx + dy * dy))
    return np.array([np.pi * dist, dy / dist, dx / dist, 0.0], dtype=np.float32)


def trackball_motion(prev_rotation: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Compose a drag onto an existing axis-angle rotation
    (ray.cpp:91-98)."""
    if dx == 0 and dy == 0:
        return prev_rotation
    rot = drag_to_rotation(dx, dy)
    return mat4.rotation_mult_rotation(prev_rotation, rot)


def create_camera_matrix(viewpoint: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(camera_matrix, camera_normal_matrix) — eye->world ray transform
    (ray.cpp:100-117): translation to the viewpoint; normal matrix is
    the inverse-transpose with the projective row zeroed."""
    matrix = mat4.make_translation(viewpoint[0], viewpoint[1], viewpoint[2])
    normal = mat4.zero_bottom_row(mat4.transpose(mat4.invert(matrix)))
    return matrix, normal


def create_object_matrix(
    center: np.ndarray, rotation: np.ndarray, position: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(matrix, inverse, normal, normal_inverse) — world->object ray
    transform (ray.cpp:119-140): rotation then translation to
    center+position, composed in the reference's reverse order."""
    rot_m = mat4.make_rotation(rotation[0], rotation[1], rotation[2], rotation[3])
    trans_m = mat4.make_translation(
        center[0] + position[0], center[1] + position[1], center[2] + position[2]
    )
    matrix = mat4.mult(rot_m, trans_m)  # ref mat4_mult(rot, trans, out)
    inverse = mat4.invert(matrix)
    normal = mat4.zero_bottom_row(mat4.invert(mat4.transpose(matrix)))
    normal_inverse = mat4.zero_bottom_row(mat4.transpose(matrix))
    return matrix, inverse, normal, normal_inverse


def update_light(light_rotation: np.ndarray) -> np.ndarray:
    """Rotate the canonical light direction (0,0,1) by the light's
    axis-angle rotation via the inverse-transpose (ray.cpp:142-160)."""
    light_matrix = mat4.make_rotation(
        light_rotation[0], light_rotation[1], light_rotation[2], light_rotation[3]
    )
    light_normal = mat4.zero_bottom_row(
        mat4.invert(mat4.transpose(light_matrix))
    )
    return mat4.transform_vector(light_normal, np.array([0.0, 0.0, 1.0], np.float32))


def update_view_params(
    world,
    zoom: float,
    object_rotation: np.ndarray,
    object_position: np.ndarray,
) -> None:
    """Recompute the world's 6 view matrices from interaction state
    (ray.cpp:162-173): camera at (0, 0, zoom), object at
    scene_center + position with the trackball rotation."""
    viewpoint = np.array([0.0, 0.0, zoom], dtype=np.float32)
    world.camera_matrix, world.camera_normal_matrix = create_camera_matrix(viewpoint)
    (
        world.object_matrix,
        world.object_inverse,
        world.object_normal_matrix,
        world.object_normal_inverse,
    ) = create_object_matrix(world.scene_center, object_rotation, object_position)


def initial_light_rotation() -> np.ndarray:
    """-20 degrees about normalize(+X, -Y) (ray.cpp:1082-1085)."""
    return np.array(
        [mat4.to_radians(-20.0), 0.707, -0.707, 0.0], dtype=np.float32
    )


def initial_zoom(scene_extent: float, fov: float) -> float:
    """Frame the whole scene: extent/2/sin(fov/2) (ray.cpp:1079)."""
    return float(scene_extent / 2.0 / np.sin(fov / 2.0))
