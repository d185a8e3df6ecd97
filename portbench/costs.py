"""The yardstick's arithmetic: the operation costs of a walk's tests and
the card's published peaks, frozen here so that no change to the program
moves a bound.

Per-test costs are chip_smoke.py's bound model (the port's own smoke
test), copied as they stood when this benchmark was written: the
operations a sequential walk with early exits executes in float32, a
fused multiply-add counted as 2.  A slab test of one box is 26
operations; a Woop triangle test is 17 up to its distance test, 14 more
up to its u test and 16 more to its end.  The benchmark charges them on
its own reference walk (reference.BVH.trace), never on the program's.

Peaks: NVIDIA's H100 SXM data sheet, dense, without sparsity, at the
card's full 700 W power limit: 67 TFLOP/s in float32 outside the tensor
cores and 3.35 TB/s of HBM3.  A card set below 700 W reaches less, so
every result line carries the card's power limit beside the shares
computed against these peaks.
"""

from __future__ import annotations

OPS_PER_SLAB = 26
OPS_WOOP = (17, 14, 16)
PEAK_F32 = 67e12      # FLOP/s
PEAK_BYTES = 3.35e12  # bytes/s
TRIANGLE_BYTES = 72   # a triangle's three float32 vertices and three normals
PIXEL_BYTES = 12      # a float32 RGB pixel of the frame's linear mean
UNIFORM_BYTES = 52 * 4
JITTER_BYTES = 2 * 4


def walk_ops(slabs: int, tris: int, tris_t: int, tris_u: int) -> int:
    """Operations of a walk's counted work: slab tests, triangle tests,
    and the triangle tests that passed the distance test and then u."""
    return slabs * OPS_PER_SLAB + tris * OPS_WOOP[0] + tris_t * OPS_WOOP[1] + tris_u * OPS_WOOP[2]


def launch_bytes(triangles: int, width: int, height: int, samples: int) -> int:
    """Bytes one frame-kernel launch of ``samples`` samples must move at
    the least: the triangles once, the uniforms and jitters in, the
    frame's linear mean out."""
    return (triangles * TRIANGLE_BYTES + UNIFORM_BYTES + samples * JITTER_BYTES
            + width * height * PIXEL_BYTES)


def bound_seconds(ops: float, moved: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    return max(ops / PEAK_F32, moved / PEAK_BYTES)
