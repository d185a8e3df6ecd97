"""Scene and frame state carried over from the reference package as
plain numpy fields, so both engines render the same scene and camera:
``{f: getattr(jax_obj, f) for f in ...}`` -> the port's objects.
``packed_from_numpy`` goes on to the port's packed tables, wide or
binary, from the same host inputs the reference packers read."""

from __future__ import annotations

import numpy as np
import torch

from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.world import SceneData
from shader_ray_tpu_torch.ops.pack import PackedBinary, pack_scene
from shader_ray_tpu_torch.ops.pack_wide import PackedWide, pack_scene_wide
from shader_ray_tpu_torch.ops.render import FrameParams


def scene_data_from_numpy(fields: dict[str, np.ndarray]) -> SceneData:
    """SceneData from the reference SceneData's fields (numpy arrays and
    ints)."""
    return SceneData(
        tri_positions=np.ascontiguousarray(fields["tri_positions"], np.float32),
        tri_normals=np.ascontiguousarray(fields["tri_normals"], np.float32),
        tri_colors=np.ascontiguousarray(fields["tri_colors"], np.float32),
        node_boxes=np.ascontiguousarray(fields["node_boxes"], np.float32),
        node_objects=np.ascontiguousarray(fields["node_objects"], np.int32),
        node_children=np.ascontiguousarray(fields["node_children"], np.int32),
        tree_root=int(fields["tree_root"]),
        triangle_count=int(fields["triangle_count"]),
        group_count=int(fields["group_count"]),
        hitmiss=None if fields.get("hitmiss") is None
        else np.ascontiguousarray(fields["hitmiss"], np.int32),
        node_axis=None if fields.get("node_axis") is None
        else np.ascontiguousarray(fields["node_axis"], np.int32),
    )


def packed_from_numpy(
    fields: dict[str, np.ndarray], env: np.ndarray, kernel: str = "wide",
    config: Config | None = None,
) -> PackedWide | PackedBinary:
    """The port's packed tables from the host inputs of the reference's
    ``pack_scene_wide`` (``kernel="wide"``) or ``pack_scene``
    (``"binary"``): its SceneData's fields, hit/miss links included, and
    the env image."""
    data = scene_data_from_numpy(fields)
    if kernel == "wide":
        return pack_scene_wide(data, env, config)
    if kernel == "binary":
        return pack_scene(data, env, config)
    raise ValueError(f"kernel={kernel!r}: need 'wide' or 'binary'")


def frame_params_from_numpy(fields: dict[str, np.ndarray]) -> FrameParams:
    """FrameParams (f32 CPU tensors; the Renderer moves them to its
    device) from the reference FrameParams' fields."""
    out = {}
    for name in FrameParams._fields:
        x = fields.get(name)
        out[name] = None if x is None else torch.from_numpy(np.array(x, np.float32))
    return FrameParams(**out)
