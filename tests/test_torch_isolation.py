"""The port stands alone: importing every module of shader_ray_tpu_torch
(and chip_smoke.py) loads no jax and nothing of shader_ray_tpu; the
Renderer refuses to fall back to the CPU on its own; and, on a host
with a CUDA card and nvcc, the hand-written frame kernel agrees with its
plain PyTorch version."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import shader_ray_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "shader_ray_tpu_torch")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, names in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "build"]  # generated output
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _foreign(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "shader_ray_tpu" \
        or name.startswith("shader_ray_tpu.")


def test_no_foreign_imports_in_sources():
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_foreign(n) for n in names), f"{path}: imports {names}"


def test_importing_every_module_loads_no_jax():
    modules = ["chip_smoke"] + [
        m.name for m in pkgutil.walk_packages(shader_ray_tpu_torch.__path__, "shader_ray_tpu_torch.")
    ]
    assert len(modules) >= 20
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'shader_ray_tpu' or m.startswith('shader_ray_tpu.')]\n"
        "print('FOREIGN', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_renderer_needs_the_card_unless_cpu_is_asked(monkeypatch):
    from shader_ray_tpu_torch.engine import Renderer, pick_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pick_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(None, None)
    assert pick_device("cpu") == torch.device("cpu")


def test_frame_kernel_rejects_mixed_devices():
    from shader_ray_tpu_torch.models.fixtures import procedural_sky, uv_sphere
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops.frame_kernel import FrameSettings, frame_kernel
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide

    pos, nrm = uv_sphere(lat=4, lon=6)
    packed = pack_scene_wide(get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm))),
                             procedural_sky(32))
    with pytest.raises(ValueError, match="device"):
        frame_kernel(packed, torch.zeros(52, device="meta"), torch.zeros((1, 2)),
                     FrameSettings(width=4, height=4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the frame kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_frame_kernel_matches_plain_on_card(cuda_device):
    """Kernel vs plain version on the same card inputs at 64x64, K=2.
    Mean abs colour diff <= 1e-4 and cast counts within 0.01%: nvcc
    contracts multiply-adds into FMAs, so a few near-threshold rays may
    flip."""
    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops import frame_kernel as fk
    from shader_ray_tpu_torch.ops.engine_frame import halton_jitters, pack_uniforms
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide
    from shader_ray_tpu_torch.ops.render import default_frame_params
    from shader_ray_tpu_torch.utils import mat4

    pos, nrm = bunny_class_scene(5000)
    packed = pack_scene_wide(get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm))),
                             procedural_sky(256)).to(cuda_device)
    params = default_frame_params(device=cuda_device)._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0.0, 0.0, 3.8)).to(cuda_device),
        diffuse_color=torch.tensor([0.8, 0.2, 0.2], device=cuda_device),
    )
    uni = pack_uniforms(params)
    jit = torch.from_numpy(halton_jitters(2)).to(cuda_device)
    fs = fk.FrameSettings(width=64, height=64)
    before = fk.LAUNCHES["frame_kernel"]
    kc, kn = fk.frame_kernel(packed, uni, jit, fs)
    assert fk.LAUNCHES["frame_kernel"] == before + 1
    pc, pn = fk.frame_plain(packed, uni, jit, fs)
    torch.cuda.synchronize()
    assert torch.isfinite(kc).all()
    assert float((kc - pc).abs().mean()) <= 1e-4
    assert abs(int(kn[0]) - int(pn[0])) <= 1e-4 * int(pn[0]) + 1
    assert np.asarray(kc.shape).tolist() == [64, 64, 3]
