"""The port stands alone: importing every module of shader_ray_tpu_torch
(and chip_smoke.py) loads no jax and nothing of shader_ray_tpu; the
Renderer refuses to fall back to the CPU on its own; and, on a host
with a CUDA card and nvcc, each hand-written kernel (frame, wide trace,
binary trace, env sampler) agrees with its plain PyTorch version — the
frame kernel also on the control-flow cases of its wave compaction
(chip_smoke.FRAME_CASES), whose plain frames are checked here on the CPU
to show the path each case is for.  This file imports no jax, so its
card tests run where jax is not installed."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import shader_ray_tpu_torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

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
    from shader_ray_tpu_torch.config import Config

    for cfg in (Config(packet_fused=False), Config(packet_kernel="binary")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Renderer(None, None, cfg)


def test_wrappers_do_not_fall_back_when_the_kernel_cannot_build(monkeypatch):
    """A wrapper takes the plain version only for CPU tensors.  With the
    tensors' device reported as the card and no compiler to build the
    kernel, every wrapper raises instead of answering from its plain
    version, and counts no launch."""
    from shader_ray_tpu_torch.models.fixtures import procedural_sky, uv_sphere
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops import _build, env_kernel, frame_kernel, trace_kernel
    from shader_ray_tpu_torch.ops.pack import pack_scene
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "one_device", lambda where, tensors: torch.device("cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    pos, nrm = uv_sphere(lat=4, lon=6)
    data = get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm)))
    wide, binary = pack_scene_wide(data, procedural_sky(32)), pack_scene(data, procedural_sky(32))
    P = torch.zeros((8, 3))
    D = torch.ones((8, 3))
    before = dict(_build.LAUNCHES)
    calls = [
        lambda: trace_kernel.trace_wide(wide, P, D),
        lambda: trace_kernel.trace_binary(binary, P, D, any_hit=True),
        lambda: env_kernel.env_sample(wide.env_pyramid, D),
        lambda: env_kernel.env_sample(binary.env_pyramid, D, D, D, grad=True, aniso=4),
        lambda: frame_kernel.frame_kernel(wide, torch.zeros(52), torch.zeros((1, 2)),
                                          frame_kernel.FrameSettings(width=4, height=4)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert dict(_build.LAUNCHES) == before
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launched("env_sample", 1)
    assert dict(_build.LAUNCHES) == before


def test_build_tag_covers_included_headers(tmp_path, monkeypatch):
    """The cache tag hashes every source a library includes, so an edit
    of the shared walk header rebuilds both libraries that include it."""
    from shader_ray_tpu_torch.ops import _build

    names = {p.name for p in _build.sources_of("frame_kernel")}
    assert names == {"frame_kernel.cu", "walk.cuh"}
    assert {p.name for p in _build.sources_of("trace_kernel")} == {"trace_kernel.cu", "walk.cuh"}
    assert {p.name for p in _build.sources_of("trace_binary_kernel")} == \
        {"trace_binary_kernel.cu", "walk.cuh"}
    assert {p.name for p in _build.sources_of("env_kernel")} == {"env_kernel.cu"}
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._paths(n)[0].name for n in ("frame_kernel", "trace_kernel", "env_kernel")}
    with open(csrc / "walk.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._paths(n)[0].name for n in before}
    assert after["frame_kernel"] != before["frame_kernel"]
    assert after["trace_kernel"] != before["trace_kernel"]
    assert after["env_kernel"] == before["env_kernel"]


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
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_frame_kernel_matches_plain_on_card(cuda_device):
    """Kernel vs plain version on the same card inputs at 64x64, K=2,
    with chip_smoke's limits (mean abs colour <= 1e-4, cast counts within
    0.01%, walk counters within theirs): nvcc contracts multiply-adds
    into FMAs, so a few near-threshold rays may flip."""
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
    before = fk._build.LAUNCHES["frame_kernel"]
    kc, kn = fk.frame_kernel(packed, uni, jit, fs)
    assert fk._build.LAUNCHES["frame_kernel"] == before + 1
    pc, pn = fk.frame_plain(packed, uni, jit, fs)
    torch.cuda.synchronize()
    assert chip_smoke.frame_disagreement(kc, kn.cpu(), pc, pn.cpu()) is None
    assert np.asarray(kc.shape).tolist() == [64, 64, 3]


def _card_scene(device, kernel: str):
    """5000 flat-shaded triangles plus a unit sphere with smooth normals
    (so the normal interpolation shows)."""
    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky, uv_sphere
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops.pack import pack_scene
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide

    pos, _ = bunny_class_scene(5000)
    spos, snrm = uv_sphere(lat=24, lon=32, radius=0.7, center=(0.8, 0.8, 0.8))
    pos = np.asarray(pos, np.float32).reshape(-1, 3, 3)
    flat = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    flat /= np.maximum(np.linalg.norm(flat, axis=1, keepdims=True), 1e-30)
    nrm = np.concatenate([np.repeat(flat[:, None], 3, axis=1), snrm]).astype(np.float32)
    data = get_shader_data(make_world(TriangleSet.from_arrays(np.concatenate([pos, spos]), nrm)))
    pack = pack_scene_wide if kernel == "wide" else pack_scene
    return pack(data, procedural_sky(64)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["wide", "binary"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_trace_kernel_matches_plain_on_card(cuda_device, kernel, any_hit):
    """Kernel vs plain version on the same card inputs (4096 seeded
    rays).  nvcc contracts multiply-adds into FMAs, so a grazing ray may
    flip: hit flags differ on <= 0.1% of rays, t agrees at rtol 1e-4
    where both hit, ids are equal except at ties (|dt| < 1e-6), and on
    closest hits with equal ids the interpolated normals agree to 1e-5
    mean abs (1e-3 max: a grazing hit amplifies the rounding of d)."""
    from shader_ray_tpu_torch.ops import trace_kernel as tk

    packed = _card_scene(cuda_device, kernel)
    rng = np.random.default_rng(31)
    P = torch.from_numpy(rng.uniform(-1.6, 1.6, (4096, 3)).astype(np.float32)).to(cuda_device)
    D = rng.normal(size=(4096, 3)).astype(np.float32)
    D[:64] = [0.0, 0.0, 1.0]
    D = torch.from_numpy(D).to(cuda_device)
    active = torch.from_numpy(rng.uniform(size=4096) < 0.8).to(cuda_device)
    name = f"trace_{kernel}"
    before = tk._build.LAUNCHES[name]
    got = tk.trace(packed, P, D, active, any_hit=any_hit, with_stats=True)
    assert tk._build.LAUNCHES[name] == before + 1
    plain = tk.walk_plain if kernel == "wide" else tk.walk_binary_plain
    want = tk.packet_hit(plain(packed, P, D, active, any_hit), True)
    torch.cuda.synchronize()
    hit, hit_w = got.t < tk.INFINITELY_FAR, want.t < tk.INFINITELY_FAR
    assert float((hit != hit_w).float().mean()) <= 1e-3
    both = hit & hit_w
    torch.testing.assert_close(got.t[both], want.t[both], rtol=1e-4, atol=1e-6)
    differ = both & (got.which != want.which)
    assert ((got.t - want.t)[differ].abs() < 1e-6).all()
    assert torch.equal(got.bad, want.bad) and not hit[~active].any()
    if not any_hit:
        same = both & (got.which == want.which)
        dn = (got.normal - want.normal)[same].abs()
        assert same.sum() > 100 and float(dn.mean()) <= 1e-5 and float(dn.max()) <= 1e-3
        smooth = same & (got.which >= 0) & ((got.normal.norm(dim=1) - 1.0).abs() > 1e-4)
        assert smooth.sum() > 20   # interpolated inside a smooth triangle, not a flat one


@pytest.mark.cuda
@pytest.mark.parametrize("grad,aniso", [(False, 1), (True, 1), (True, 4)])
def test_env_kernel_matches_plain_on_card(cuda_device, grad, aniso):
    """Kernel vs plain version on the same card inputs: both call the
    card's atan2f/acosf/log2f, so they agree to the rounding of the
    blend, rtol 1e-4 / atol 1e-4 (the sky's sun reaches ~50)."""
    from shader_ray_tpu_torch.models.fixtures import procedural_sky
    from shader_ray_tpu_torch.ops import _build
    from shader_ray_tpu_torch.ops.env_kernel import env_sample, env_sample_plain
    from shader_ray_tpu_torch.ops.envmap import EnvPyramid

    pyr = EnvPyramid.pack(procedural_sky(1024)).to(cuda_device)
    rng = np.random.default_rng(46)
    n = 20000
    D = rng.normal(size=(n, 3)).astype(np.float32)
    D[:4] = [[-1, 0, 1e-7], [-1, 0, -1e-7], [0.02, 0.9998, 0.0], [0.0, -0.9998, 0.02]]
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    scale = (10.0 ** rng.uniform(-4.0, -0.5, size=(n, 1))).astype(np.float32)
    gx = rng.normal(size=(n, 3)).astype(np.float32) * scale
    gy = rng.normal(size=(n, 3)).astype(np.float32) * scale * 0.3
    D, gx, gy = (torch.from_numpy(x).to(cuda_device) for x in (D, gx, gy))
    before = _build.LAUNCHES["env_sample"]
    got = env_sample(pyr, D, gx, gy, grad=grad, aniso=aniso)
    assert _build.LAUNCHES["env_sample"] == before + 1
    want = env_sample_plain(pyr, D, gx, gy, grad=grad, aniso=aniso)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", chip_smoke.FRAME_CASES)
def test_frame_cases_show_their_paths(name):
    """Each control-flow case, rendered by frame_plain on the CPU, shows
    the path it is for: no hit at all, every ray hitting through all its
    bounces, bad rays painted, no bounce, one bounce without shadows, no
    diffuse, three samples on a frame that is no whole number of tiles."""
    from shader_ray_tpu_torch.ops import frame_kernel as fk

    packed, uni, jit, fs = chip_smoke.frame_case(name, torch.device("cpu"))
    colour, counters = fk.frame_plain(packed, uni, jit, fs)
    assert chip_smoke.case_unmet(name, fs, colour, counters) is None


@pytest.mark.parametrize("name", chip_smoke.FRAME_CASES)
def test_case_check_refuses_a_frame_off_its_path(name):
    """Each case's check refuses a frame that did not take the case's
    path, so a kernel that skips the path fails on the card."""
    _, _, jit, fs = chip_smoke.frame_case(name, torch.device("cpu"))
    primaries = jit.shape[0] * fs.width * fs.height
    colour = torch.zeros((fs.height, fs.width, 3))
    counters = torch.zeros(1 + 3 * fs.phases(), dtype=torch.long)
    counters[0] = primaries
    if name == "all-miss":
        counters[0] = primaries + 1                 # a primary hit, bounced on
    elif name == "all-hit":
        colour[0, 0] = torch.tensor([1.0, 0.0, 0.0])  # a bad ray
        counters[0] = 2 * fs.bounce_count * primaries
    elif name == "bounces0":
        counters = torch.tensor([1])                # a ray was cast
    elif name in ("bounces1-noshadow", "nodiffuse"):
        counters = torch.zeros(1 + 6 * fs.bounce_count, dtype=torch.long)  # shadow phases
        counters[0] = primaries
    elif name == "k3-ragged":
        colour = torch.zeros((32, 48, 3))            # whole tiles, not the frame
    # "bad": no pixel painted red
    assert chip_smoke.case_unmet(name, fs, colour, counters) is not None


@pytest.mark.parametrize("fault", ["shape", "counter-row", "non-finite", "colour", "cast",
                                   "walk-counters", "walk-phase"])
def test_frame_gate_refuses_each_fault(fault):
    """chip_smoke's gate of a kernel frame against its plain version
    passes differences inside its limits (mean abs colour 1e-4, one ray
    cast on a small frame, a walk counter 1e-3 of its count or 1e-4 of
    the frame's walk total) and refuses each kind beyond them."""
    colour = torch.full((6, 8, 3), 0.5)
    # rays cast; node pops, leaf visits, triangle tests of two phases
    counters = torch.tensor([1000, 500000, 200000, 800000, 20000, 8000, 30000])
    near_c, near_n = colour + 5e-5, counters.clone()
    near_n[0] += 1
    near_n[1] -= 400   # under 1e-3 of its count
    near_n[5] += 120   # under 1e-4 of the walk total, above 1e-3 of its count
    assert chip_smoke.frame_disagreement(near_c, near_n, colour, counters) is None
    kc, kn = colour.clone(), counters.clone()
    if fault == "shape":
        kc = kc[:, :7]
    elif fault == "counter-row":
        kn = kn[:1]
    elif fault == "non-finite":
        kc[2, 3, 1] = float("nan")
    elif fault == "colour":
        kc += 2e-4
    elif fault == "cast":
        kn[0] += 2
    elif fault == "walk-counters":
        kn[3] += 1000     # a warp's triangle tests dropped or doubled
    else:
        kn[4:] = counters[1:4] // 40   # a phase's counts under another phase
    assert chip_smoke.frame_disagreement(kc, kn, colour, counters) is not None


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.FRAME_CASES)
def test_frame_kernel_control_flow_on_card(cuda_device, name):
    """The frame kernel against frame_plain on the paths its compaction
    creates (empty queues, full queues, bad rays, no or one bounce,
    shadows or diffuse off, K=3 on a ragged frame), with chip_smoke's
    limits: mean abs colour <= 1e-4, rays cast within 1e-4 (one ray on a
    small frame), each walk counter within its limit, and the same
    bad-painted pixels up to one."""
    from shader_ray_tpu_torch.ops import frame_kernel as fk

    packed, uni, jit, fs = chip_smoke.frame_case(name, cuda_device)
    before = fk._build.LAUNCHES["frame_kernel"]
    kc, kn = fk.frame_kernel(packed, uni, jit, fs)
    assert fk._build.LAUNCHES["frame_kernel"] == before + 1
    pc, pn = fk.frame_plain(packed, uni, jit, fs)
    torch.cuda.synchronize()
    assert chip_smoke.frame_disagreement(kc, kn.cpu(), pc, pn.cpu()) is None
    assert chip_smoke.case_unmet(name, fs, kc, kn.cpu()) is None
    red = torch.tensor([1.0, 0.0, 0.0], device=cuda_device)
    assert int(((kc == red).all(-1) != (pc == red).all(-1)).sum()) <= 1
