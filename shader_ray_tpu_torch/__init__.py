"""PyTorch/CUDA port of shader_ray_tpu.

The host side (scene build, SAH BVH, 8-wide collapse, binary hit/miss
links, env pyramid) is numpy.  A frame runs as one hand-written CUDA
kernel per frame batch (``ops/frame_kernel.py``, ``csrc/frame_kernel.cu``)
or, unfused, as trace and env kernels (``ops/trace_kernel.py``,
``ops/env_kernel.py``) with plain PyTorch shading between them
(``ops/engine_trace.py``); every kernel has a plain PyTorch version of
the same function for CPU tensors.  ``python -m shader_ray_tpu_torch
model background`` runs the app (``app/``: the CLI and REPL over
``engine.Renderer``).  The package imports torch and numpy only — never
jax, never shader_ray_tpu.
"""
