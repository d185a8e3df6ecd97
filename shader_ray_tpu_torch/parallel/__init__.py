"""Multi-device rendering (counterpart of shader_ray_tpu/parallel/): one
controller drives an ordered list of devices, the scene tables
replicated on each; ray sharding over bands of image rows and sample
sharding of progressive batches (parallel/mesh.py)."""

from shader_ray_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate_scene,
    row_bands,
    sample_sharded,
    shard_rows,
)

__all__ = ["make_mesh", "replicate_scene", "row_bands", "sample_sharded", "shard_rows"]
