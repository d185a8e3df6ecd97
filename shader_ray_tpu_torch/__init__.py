"""PyTorch/CUDA port of shader_ray_tpu.

The host side (scene build, SAH BVH, 8-wide collapse, env pack) is
numpy; the frame runs as one hand-written CUDA kernel per frame batch
(``ops/frame_kernel.py``, ``csrc/frame_kernel.cu``) with a plain
PyTorch version of the same function for CPU tensors.  The package
imports torch and numpy only — never jax, never shader_ray_tpu.
"""
