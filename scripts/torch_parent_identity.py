#!/usr/bin/env python3
"""Hold this checkout's CUDA kernels bit for bit against another
checkout's on one card: env_sample in its three modes (seeded directions
over the whole sphere with wide footprints, and directions exactly along
+-y, NaN in grad mode), the frame kernel's bench frame in each of its
raygen modes, which=0, which=1 with aniso 1 and 4, which=2, and in its
given-rays form (which=5's 25 sets; colour and counter row), and both
trace kernels, closest and any hit, on the bench primaries (t, id,
normal, bad flag and per-ray counts), all on the default (Woop) tables;
and the binary trace kernel's machine code (cuobjdump -sass, its
instructions without their addresses and encodings), where the toolkit
has cuobjdump.  Each checkout builds its own kernels in a process of
its own; the outputs are compared here with NaN equal to NaN.

    python3 scripts/torch_parent_identity.py OTHER_CHECKOUT   # on a machine with one NVIDIA GPU

Prints one line an output and exits non-zero if any differs.
"""

from __future__ import annotations

import os
import re
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
    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.ops import env_kernel as ek
    from shader_ray_tpu_torch.ops import frame_kernel as fk
    from shader_ray_tpu_torch.ops import trace_kernel as tk
    from shader_ray_tpu_torch.ops.engine_frame import (
        pack_uniforms,
        primary_rays,
        supersample_directions,
    )
    from shader_ray_tpu_torch.ops.envmap import EnvPyramid
    from shader_ray_tpu_torch.ops.render import RenderStatics, generate_rays

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
    statics = RenderStatics(width=chip_smoke.W, height=chip_smoke.H)
    on_card = type(params)(*[x.cuda() for x in params])
    rays, (right, up) = primary_rays(statics, on_card)
    given = fk.GivenRays(rays.P.contiguous(), supersample_directions(rays.D, right, up))
    colour, counters = fk.frame_kernel(packed, pack_uniforms(params).cuda(), None,
                                       fk.FrameSettings(width=statics.width, height=statics.height),
                                       rays=given)
    out["frame_kernel which=5 colour"], out["frame_kernel which=5 counters"] = colour, counters
    rays = generate_rays(statics, on_card)
    P, D = rays.P.contiguous(), rays.D.contiguous()
    binary = Renderer(data, sky, Config(packet_kernel="binary")).packed
    for name, tables in (("trace_wide", packed), ("trace_binary", binary)):
        for any_hit in (False, True):
            hit = tk.trace(tables, P, D, any_hit=any_hit, with_stats=True, width=statics.width)
            for field in ("t", "which", "normal", "bad", "stats"):
                out[f"{name} {'any-hit' if any_hit else 'closest'} {field}"] = getattr(hit, field)
    arrays = {k: v.cpu().numpy() for k, v in out.items()}
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        _build.library("trace_binary_kernel")
        sass = subprocess.run([cuobjdump, "-sass", str(_build._paths("trace_binary_kernel")[0])],
                              capture_output=True, text=True, check=True).stdout
        code = [re.sub(r"\s+", " ", re.sub(r"/\* 0x[0-9a-f]+ \*/", "", line.split("*/", 1)[1])).strip()
                for line in sass.splitlines() if re.match(r"\s+/\*[0-9a-f]{4}\*/", line)]
        arrays["trace_binary SASS"] = np.frombuffer("\n".join(code).encode(), np.uint8)
    np.savez(path, **arrays)


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
            if key not in there.files:
                print(f"{key}: not in the other checkout's outputs")
                same = False
                continue
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
