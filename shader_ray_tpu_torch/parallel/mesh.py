"""Device mesh and sharded rendering (counterpart of
shader_ray_tpu/parallel/mesh.py and of the reference Renderer's mesh
paths, shader_ray_tpu/engine.py:149-155, :236-277).

The reference has one controller: a 1-D mesh over ``jax.devices()`` in
one process, and the CLI's ``--devices N`` needs no launcher.  So here:
a mesh is an ordered list of ``torch.device``s that one process drives,
with no ``torch.distributed`` (which would make the REPL and the CLI
multi-process).  The scene's tables are copied once to each distinct
device (``replicate_scene``).  A sharded call issues its launches to
each device in turn; launches are asynchronous, so the devices run
concurrently, and the results are gathered onto ``mesh[0]``.

* Ray sharding (``shard_rows``): device i renders band i of whole image
  rows (``row_bands``: n contiguous bands whose heights differ by at
  most one); rays are independent, so the gathered frame is the
  unsharded frame of the same rays bit for bit.
* Sample sharding (``sample_sharded``): with K % n == 0 samples, device
  i renders the jitter block [i K/n, (i+1) K/n) over the whole frame;
  the n linear means are summed on ``mesh[0]`` and divided by n (the
  reference's pmean), which differs from one K-sample mean only by the
  order of the sums.

A device may appear more than once (``["cpu", "cpu"]``, or ``[cuda:0,
cuda:0]`` on a one-card machine): each entry is a shard, and the entries
of one device share its copy of the tables.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _normal(device: torch.device) -> torch.device:
    """``cuda`` without an index is the current card's."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices: int | Sequence[str | torch.device] = 0) -> list[torch.device]:
    """The ordered device list of a mesh.  An int takes the first N CUDA
    devices (0: all of them) and raises when the machine has fewer, naming
    both numbers; a list is taken as it is (``["cpu", "cpu"]``: two CPU
    shards)."""
    if isinstance(devices, int):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = devices or count
        if n < 1 or n > count:
            raise RuntimeError(f"{n or 'all'} device(s) asked for, but this machine has {count} "
                               "CUDA device(s)")
        return [torch.device("cuda", i) for i in range(n)]
    mesh = [_normal(torch.device(d)) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def replicate_scene(scene, mesh: Sequence[torch.device]) -> dict:
    """One copy of the packed tables ``scene`` per distinct device of
    ``mesh`` (``scene.to(device)``; the device ``scene`` lies on keeps
    it)."""
    return {d: scene.to(d) for d in dict.fromkeys(mesh)}


def row_bands(height: int, n: int) -> list[tuple[int, int]]:
    """n contiguous bands (r0, r1) of ``height`` image rows, the first
    ``height % n`` one row taller; a band is empty where n > height."""
    base, extra = divmod(height, n)
    bands, r0 = [], 0
    for i in range(n):
        r1 = r0 + base + (i < extra)
        bands.append((r0, r1))
        r0 = r1
    return bands


def shard_rows(replicas: dict, mesh: Sequence[torch.device], height: int,
               render_band: Callable[[object, tuple[int, int]], torch.Tensor]) -> torch.Tensor:
    """Ray sharding: ``render_band(packed, (r0, r1))`` -> (r1 - r0, W, C)
    for each device's band of rows, every launch issued before any result
    is gathered; the (height, W, C) frame on ``mesh[0]``."""
    parts = [render_band(replicas[d], rows) for d, rows in zip(mesh, row_bands(height, len(mesh)))
             if rows[1] > rows[0]]
    return torch.cat([p.to(mesh[0]) for p in parts], dim=0)


def sample_sharded(replicas: dict, mesh: Sequence[torch.device], jitters: torch.Tensor,
                   render_block: Callable[[object, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Sample sharding of K = len(jitters) samples, K % n == 0:
    ``render_block(packed, block)`` -> the linear mean over the (K/n, 2)
    jitter block of each device; their sum on ``mesh[0]`` divided by n."""
    n = len(mesh)
    if jitters.shape[0] % n:
        raise ValueError(f"{jitters.shape[0]} samples do not split over {n} devices")
    k = jitters.shape[0] // n
    means = [render_block(replicas[d], jitters[i * k:(i + 1) * k]) for i, d in enumerate(mesh)]
    total = means[0].to(mesh[0])
    for m in means[1:]:
        total = total + m.to(mesh[0])
    return total / n
