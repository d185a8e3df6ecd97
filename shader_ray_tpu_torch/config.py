"""Configuration for the port's scene build, pack and kernels.

The fields the ported slice reads, with the reference package's
defaults and names (shader_ray_tpu/config.py); a test holds the
defaults equal.  Per-frame render settings live in
``ops.render.RenderStatics``.
There is no process-wide instance: functions take a ``Config`` or use
``Config()``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # --- BVH build knobs (reference bvh.cpp:28,32,57-58) ---
    bvh_leaf_max: int = 10          # leaf size at/below which a leaf is made
    bvh_max_depth: int = 30         # no nodes below this depth
    sah_ctrav: float = 1.0          # SAH traversal cost
    sah_cisec: float = 4.0          # SAH intersection cost

    # --- scene pack (reference raytracer.es.fs:382) ---
    max_leaf_tests: int = 10         # triangle tests per leaf visit (leaf cap)
    env_base: int = 1024             # env level-0 height cap (W = 2H)
    env_aniso: int = 4               # which=1 anisotropy probes (GL
                                     # MAX_ANISOTROPY 4, ray.cpp:505-508)

    # --- kernels ---
    packet_kernel: str = "wide"      # "wide" (8-ary short-stack) | "binary"
    packet_fused: bool = True        # one fused frame kernel per frame
                                     # (wide tables, which=0); False = the
                                     # unfused trace loop (A/B)
    packet_max_steps: int = 0        # walk budget in node pops (wide) or
                                     # node steps (binary); 0 = the walk's
                                     # own bound

    def validate(self) -> "Config":
        if self.env_base < 16 or self.env_base & (self.env_base - 1):
            raise ValueError(
                f"env_base={self.env_base} invalid: need a power of two >= 16"
            )
        if not 1 <= self.max_leaf_tests <= 31:
            # the child meta holds a leaf's count in 5 bits (ops/pack_wide.py)
            raise ValueError(f"max_leaf_tests={self.max_leaf_tests}: need 1..31")
        if self.packet_kernel not in ("wide", "binary"):
            raise ValueError(f"packet_kernel={self.packet_kernel!r}: need 'wide' or 'binary'")
        if self.env_aniso < 1:
            raise ValueError(f"env_aniso={self.env_aniso}: need >= 1")
        if self.packet_max_steps < 0:
            raise ValueError(f"packet_max_steps={self.packet_max_steps}: need >= 0")
        return self
