#!/usr/bin/env python3
"""Hold this checkout's CUDA kernels bit for bit against another
checkout's on one card: env_sample in its three modes (seeded directions
over the whole sphere with wide footprints, and directions exactly along
+-y, NaN in grad mode) and the frame kernel's bench frame in each of its
raygen modes, which=0, which=1 with aniso 1 and 4, which=2 (colour and
counter row).  Each checkout builds its own kernels in a process of
its own; the outputs are compared here with NaN equal to NaN.

    python3 scripts/torch_parent_identity.py OTHER_CHECKOUT   # on a machine with one NVIDIA GPU

Prints one line an output and exits non-zero if any differs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dump(root: str, path: str) -> None:
    """The outputs of the kernels of the checkout at ``root`` into ``path``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from shader_ray_tpu_torch.engine import Renderer
    from shader_ray_tpu_torch.models.fixtures import procedural_sky
    from shader_ray_tpu_torch.ops import env_kernel as ek
    from shader_ray_tpu_torch.ops import frame_kernel as fk
    from shader_ray_tpu_torch.ops.engine_frame import pack_uniforms
    from shader_ray_tpu_torch.ops.envmap import EnvPyramid

    pyr = EnvPyramid.pack(procedural_sky(2048)).to("cuda")
    rng = np.random.default_rng(7)
    n = 200_000
    D = rng.normal(size=(n, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    g = rng.normal(size=(2, n, 3)).astype(np.float32) * \
        (10.0 ** rng.uniform(-4.0, -1.0, size=(1, n, 1))).astype(np.float32)
    D, gx, gy = (torch.from_numpy(x).cuda() for x in (D, g[0], g[1]))
    Dp, gxp, gyp, _ = chip_smoke.pole_rays(4096, "cuda")
    out = {}
    for grad, aniso in ((False, 1), (True, 1), (True, 4)):
        mode = f"grad aniso={aniso}" if grad else "mode 0"
        out[f"env_sample {mode}"] = ek.env_sample(pyr, D, gx, gy, grad=grad, aniso=aniso)
        out[f"env_sample {mode}, rays along +-y"] = ek.env_sample(pyr, Dp, gxp, gyp, grad=grad,
                                                                   aniso=aniso)
    data, sky, params = chip_smoke.bench_inputs()
    packed = Renderer(data, sky).packed
    for which, aniso in ((0, 1), (1, 1), (1, 4), (2, 1)):
        fs = fk.FrameSettings(width=chip_smoke.W, height=chip_smoke.H, which=which, env_aniso=aniso)
        colour, counters = fk.frame_kernel(packed, pack_uniforms(params).cuda(),
                                           torch.zeros((1, 2), device="cuda"), fs)
        mode = f"which={which} aniso={aniso}"
        out[f"frame_kernel {mode} colour"], out[f"frame_kernel {mode} counters"] = colour, counters
    np.savez(path, **{k: v.cpu().numpy() for k, v in out.items()})


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--dump":
        dump(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for root in (ROOT, other):
            path = os.path.join(tmp, f"{len(outs)}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--dump", root, path],
                           check=True, cwd=root)
            outs.append(np.load(path))
        here, there = outs
        same = True
        for key in here.files:
            a, b = here[key], there[key]
            equal = a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
            same &= equal
            diff = "" if equal or a.shape != b.shape else \
                f", max abs diff {float(np.nanmax(np.abs(a.astype(np.float64) - b))):.3e}"
            print(f"{key}: {'bit-identical' if equal else 'DIFFERS'} ({a.size} values, "
                  f"{int(np.isnan(a).sum())} NaN here, {int(np.isnan(b).sum())} there{diff})")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
