"""Configuration for the port's scene load, build, pack, kernels and app.

The fields the port reads, with the reference package's defaults, names
and checks (shader_ray_tpu/config.py); ``from_env`` reads the
reference's environment variables for them.  Tests hold the defaults and
``from_env`` equal.  The reference's TPU schedule knobs are not here:
they tune machinery the port does not have.  Per-frame render settings
live in ``ops.render.RenderStatics`` (``RenderStatics.from_config``).
There is no process-wide instance: functions take a ``Config`` or use
``Config()``.
"""

from __future__ import annotations

import dataclasses
import os


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v is not None else default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v is not None else default


@dataclasses.dataclass
class Config:
    # --- BVH build knobs (reference bvh.cpp:28,32,57-58) ---
    bvh_leaf_max: int = 10          # leaf size at/below which a leaf is made
    bvh_max_depth: int = 30         # no nodes below this depth
    sah_ctrav: float = 1.0          # SAH traversal cost
    sah_cisec: float = 4.0          # SAH intersection cost

    # --- loader knobs (reference trisrc-support.cpp:24-40) ---
    colors_are_linear: bool = False  # skip pow(c, 2.63) gamma decode
    geometry_scale: float = 1.0      # positions scaled at parse time
    screen_gamma: float = 2.63       # reference trisrc-support.cpp:24

    # --- render constants (reference raytracer.es.fs) ---
    bounce_count: int = 3            # fs:550
    cast_shadows: bool = True        # fs:445
    use_filmic: bool = True          # fs:524
    do_tonemap: bool = True          # fs:525
    mt_epsilon: float = 1e-7         # Moller-Trumbore det epsilon, fs:312
    surface_fudge: float = 1e-4      # reflect origin offset, fs:87

    # --- app defaults (reference ray.cpp) ---
    window_width: int = 512          # ray.cpp:969
    window_height: int = 512
    fov_degrees: float = 40.0        # ray.cpp:1078

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
    min_contrib: float = 0.0         # throughput cutoff (fused frame kernel):
                                     # retire bounce lanes whose Schlick
                                     # modulation is at or below this in
                                     # every component; their env term uses
                                     # the current direction.  0 = exact

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
        if self.min_contrib < 0.0:
            raise ValueError(f"min_contrib={self.min_contrib} invalid: need >= 0")
        return self

    @staticmethod
    def from_env() -> "Config":
        """``Config()`` with the reference's environment variables applied
        (shader_ray_tpu/config.py:219-265), for the fields the port has."""
        c = Config()
        c.bvh_max_depth = _env_int("BVH_MAX_DEPTH", c.bvh_max_depth)
        c.bvh_leaf_max = _env_int("BVH_LEAF_MAX", c.bvh_leaf_max)
        c.sah_ctrav = _env_float("SAH_CTRAV", c.sah_ctrav)
        c.max_leaf_tests = _env_int("SRT_MAX_LEAF_TESTS", c.max_leaf_tests)
        c.sah_cisec = _env_float("SAH_CISEC", c.sah_cisec)
        c.colors_are_linear = os.environ.get("COLORS_ARE_LINEAR") is not None
        c.geometry_scale = _env_float("GEOMETRY_SCALE", c.geometry_scale)
        if os.environ.get("SRT_PACKET_KERNEL"):
            c.packet_kernel = os.environ["SRT_PACKET_KERNEL"]
        c.env_base = _env_int("SRT_ENV_BASE", c.env_base)
        c.env_aniso = _env_int("SRT_ENV_ANISO", c.env_aniso)
        c.packet_fused = _env_int("SRT_FUSED", int(c.packet_fused)) != 0
        c.min_contrib = _env_float("SRT_MIN_CONTRIB", c.min_contrib)
        c.packet_max_steps = _env_int("SRT_MAX_STEPS", c.packet_max_steps)
        return c.validate()
