"""The port stands alone: importing every module of shader_ray_tpu_torch
(and chip_smoke.py) loads no jax and nothing of shader_ray_tpu, and none
imports PIL (the card's machine has none); the
Renderer refuses to fall back to the CPU on its own; and, on a host
with a CUDA card and nvcc, each hand-written kernel (frame, wide trace,
binary trace, env sampler) agrees with its plain PyTorch version — the
frame kernel also on the control-flow cases of its wave compaction
(chip_smoke.FRAME_CASES), whose plain frames are checked here on the CPU
to show the path each case is for.  This file imports no jax, so its
card tests run where jax is not installed."""

import ast
import functools
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


def test_no_module_imports_pil():
    """The card's machine has no PIL: the image readers are the port's own."""
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n == "PIL" or n.startswith("PIL.") for n in names), f"{path}: imports {names}"


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
        lambda: frame_kernel.frame_kernel(
            wide, torch.zeros(52), torch.zeros((1, 2)),
            frame_kernel.FrameSettings(width=4, height=4, which=1, env_aniso=4),
            tile_rows=torch.zeros((1, 19), dtype=torch.long)),
        lambda: frame_kernel.frame_kernel(
            wide, torch.zeros(52), None,
            frame_kernel.FrameSettings(width=4, height=4, min_contrib=0.5),
            rays=frame_kernel.GivenRays(torch.zeros((16, 3)), torch.ones((25, 16, 3)))),
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
    of a shared header (the walk, the env lookup) rebuilds every library
    that includes it and no other."""
    from shader_ray_tpu_torch.ops import _build

    names = {p.name for p in _build.sources_of("frame_kernel")}
    assert names == {"frame_kernel.cu", "walk.cuh", "env.cuh"}
    assert {p.name for p in _build.sources_of("trace_kernel")} == {"trace_kernel.cu", "walk.cuh"}
    assert {p.name for p in _build.sources_of("trace_binary_kernel")} == \
        {"trace_binary_kernel.cu", "walk.cuh"}
    assert {p.name for p in _build.sources_of("env_kernel")} == {"env_kernel.cu", "env.cuh"}
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC.iterdir():
        if path.is_file():  # csrc/host/ holds the native builder's C++, not a kernel
            (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._paths(n)[0].name for n in ("frame_kernel", "trace_kernel", "env_kernel")}
    with open(csrc / "walk.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._paths(n)[0].name for n in before}
    assert after["frame_kernel"] != before["frame_kernel"]
    assert after["trace_kernel"] != before["trace_kernel"]
    assert after["env_kernel"] == before["env_kernel"]
    with open(csrc / "env.cuh", "a") as f:
        f.write("// edited\n")
    again = {n: _build._paths(n)[0].name for n in before}
    assert again["frame_kernel"] != after["frame_kernel"]
    assert again["env_kernel"] != after["env_kernel"]
    assert again["trace_kernel"] == after["trace_kernel"]


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


@functools.cache
def _card_data():
    """5000 flat-shaded triangles plus a unit sphere with smooth normals
    (so the normal interpolation shows), as SceneData."""
    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, uv_sphere
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world

    pos, _ = bunny_class_scene(5000)
    spos, snrm = uv_sphere(lat=24, lon=32, radius=0.7, center=(0.8, 0.8, 0.8))
    pos = np.asarray(pos, np.float32).reshape(-1, 3, 3)
    flat = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    flat /= np.maximum(np.linalg.norm(flat, axis=1, keepdims=True), 1e-30)
    nrm = np.concatenate([np.repeat(flat[:, None], 3, axis=1), snrm]).astype(np.float32)
    return get_shader_data(make_world(TriangleSet.from_arrays(np.concatenate([pos, spos]), nrm)))


def _card_scene(device, kernel: str, isect: str = "woop"):
    """_card_data's tables: binary, or wide with leaf test rows of form
    ``isect``."""
    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.models.fixtures import procedural_sky
    from shader_ray_tpu_torch.ops.pack import pack_scene
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide

    pack = pack_scene_wide if kernel == "wide" else pack_scene
    return pack(_card_data(), procedural_sky(64), Config(leaf_isect=isect)).to(device)


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
    blend, rtol 1e-4 / atol 1e-4 (the sky's sun reaches ~50).  Rays
    exactly along +-y are NaN in grad mode in both, finite in mode 0."""
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
    D[4:6] = [[0, 1, 0], [0, -1, 0]]
    scale = (10.0 ** rng.uniform(-4.0, -0.5, size=(n, 1))).astype(np.float32)
    gx = rng.normal(size=(n, 3)).astype(np.float32) * scale
    gy = rng.normal(size=(n, 3)).astype(np.float32) * scale * 0.3
    D, gx, gy = (torch.from_numpy(x).to(cuda_device) for x in (D, gx, gy))
    before = _build.LAUNCHES["env_sample"]
    got = env_sample(pyr, D, gx, gy, grad=grad, aniso=aniso)
    assert _build.LAUNCHES["env_sample"] == before + 1
    want = env_sample_plain(pyr, D, gx, gy, grad=grad, aniso=aniso)
    torch.cuda.synchronize()
    poles = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    poles[4:6] = grad
    assert torch.equal(torch.isnan(want), poles[:, None].expand(n, 3))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isfinite(got[~poles]).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, equal_nan=True)


ENV_FAULTS = ("none", "one-ray-off", "all-rays-off", "nan-at-a-finite-ray", "finite-at-a-pole",
              "inf-at-a-ray", "plain-nan-off-the-poles")


@pytest.mark.parametrize("fault", ENV_FAULTS)
def test_env_gate_refuses_each_fault(fault):
    """chip_smoke.env_disagreement passes the plain version against
    itself and refuses each fault a kernel could have: a ray off by more
    than 1e-2, every ray off by more than 1e-5 on average, NaN where the
    plain version is finite or a finite value where it is NaN, an
    infinite value, and a plain version NaN off the expected rays."""
    from shader_ray_tpu_torch.models.fixtures import procedural_sky
    from shader_ray_tpu_torch.ops.env_kernel import env_sample_plain
    from shader_ray_tpu_torch.ops.envmap import EnvPyramid

    pyr = EnvPyramid.pack(procedural_sky(64))
    D, gx, gy, axis = chip_smoke.pole_rays(256, torch.device("cpu"))
    assert int(axis.sum()) == 64 and (D[axis, 1].abs() == 1).all() and (D[axis][:, [0, 2]] == 0).all()
    want = env_sample_plain(pyr, D, gx, gy, grad=True, aniso=4)
    got = want.clone()
    expect = axis.clone()
    i, j = int((~axis).nonzero()[0]), int(axis.nonzero()[0])
    if fault == "one-ray-off":
        got[i, 1] += 0.02
    elif fault == "all-rays-off":
        got = got + 2e-5
    elif fault == "nan-at-a-finite-ray":
        got[i, 0] = float("nan")
    elif fault == "finite-at-a-pole":
        got[j] = 0.5
    elif fault == "inf-at-a-ray":
        got[i, 2] = float("inf")
    elif fault == "plain-nan-off-the-poles":
        expect[j] = False
    _, why = chip_smoke.env_disagreement(got, want, expect)
    assert (why is None) == (fault == "none"), why


@pytest.mark.parametrize("name", chip_smoke.FRAME_CASES)
def test_frame_cases_show_their_paths(name):
    """Each control-flow case, rendered by frame_plain on the CPU, shows
    the path it is for: no hit at all, every ray hitting through all its
    bounces, bad rays painted, no bounce, one bounce without shadows, no
    diffuse, three samples on a frame that is no whole number of tiles."""
    from shader_ray_tpu_torch.ops import frame_kernel as fk

    packed, uni, jit, fs, rays = chip_smoke.frame_case(name, torch.device("cpu"))
    colour, counters = fk.frame_plain(packed, uni, jit, fs, rays=rays)
    assert chip_smoke.case_unmet(name, fs, colour, counters) is None


@pytest.mark.parametrize("name", chip_smoke.FRAME_CASES)
def test_case_check_refuses_a_frame_off_its_path(name):
    """Each case's check refuses a frame that did not take the case's
    path, so a kernel that skips the path fails on the card."""
    packed, uni, jit, fs, _ = chip_smoke.frame_case(name, torch.device("cpu"))
    primaries = chip_smoke.CASE_SAMPLES.get(name, 1) * fs.width * fs.height
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
    elif name == "min-contrib-1":
        counters[0] = 2 * primaries
        counters[7] = 1                             # a walk after bounce 0
    elif name.startswith("min-contrib"):
        from shader_ray_tpu_torch.ops import frame_kernel as fk

        # the exact frame: no lane retired
        colour, counters = fk.frame_plain(packed, uni, jit, fs._replace(min_contrib=0.0))
    # "bad": no pixel painted red; "given-*": no ray bounced, or no NaN at the pole
    assert chip_smoke.case_unmet(name, fs, colour, counters) is not None


@pytest.mark.parametrize("fault", ["shape", "counter-row", "non-finite", "colour", "cast",
                                   "walk-counters", "walk-phase", "finite-at-a-plain-nan"])
def test_frame_gate_refuses_each_fault(fault):
    """chip_smoke's gate of a kernel frame against its plain version
    passes differences inside its limits (mean abs colour 1e-4, one ray
    cast on a small frame, a walk counter 1e-3 of its count or 1e-4 of
    the frame's walk total, NaN where the plain version has it) and
    refuses each kind beyond them."""
    colour = torch.full((6, 8, 3), 0.5)
    # rays cast; node pops, leaf visits, triangle tests of two phases
    counters = torch.tensor([1000, 500000, 200000, 800000, 20000, 8000, 30000])
    near_c, near_n = colour + 5e-5, counters.clone()
    near_n[0] += 1
    near_n[1] -= 400   # under 1e-3 of its count
    near_n[5] += 120   # under 1e-4 of the walk total, above 1e-3 of its count
    assert chip_smoke.frame_disagreement(near_c, near_n, colour, counters) is None
    pole = colour.clone()
    pole[3, 4] = float("nan")  # a grad-mode ray along +-y, NaN in both
    near_c[3, 4] = float("nan")
    assert chip_smoke.frame_disagreement(near_c, near_n, pole, counters) is None
    kc, kn = colour.clone(), counters.clone()
    if fault == "finite-at-a-plain-nan":
        colour = pole
    elif fault == "shape":
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

    packed, uni, jit, fs, rays = chip_smoke.frame_case(name, cuda_device)
    before = fk._build.LAUNCHES["frame_kernel"]
    kc, kn = fk.frame_kernel(packed, uni, jit, fs, rays=rays)
    assert fk._build.LAUNCHES["frame_kernel"] == before + 1
    pc, pn = fk.frame_plain(packed, uni, jit, fs, rays=rays)
    torch.cuda.synchronize()
    assert chip_smoke.frame_disagreement(kc, kn.cpu(), pc, pn.cpu()) is None
    assert chip_smoke.case_unmet(name, fs, kc, kn.cpu()) is None
    red = torch.tensor([1.0, 0.0, 0.0], device=cuda_device)
    assert int(((kc == red).all(-1) != (pc == red).all(-1)).sum()) <= 1
    if fs.min_contrib >= 1.0:  # every hit lane retired after bounce 0
        oc, on = fk.frame_kernel(packed, uni, jit, fs._replace(bounce_count=1))
        assert torch.equal(kc, oc) and torch.equal(kn[:on.numel()], on)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bilinear", "grad", "probes", "dy"])
def test_frame_kernel_tile_rows_on_card(cuda_device, mode):
    """Each instantiation's per-tile counter rows on the card sum to its
    frame row exactly, and its frame row is the plain version's within
    chip_smoke's limits (FRAME_CASES "which1" sets the scene)."""
    from shader_ray_tpu_torch.ops import frame_kernel as fk

    packed, uni, jit, fs, _ = chip_smoke.frame_case("which1", cuda_device)
    fs = fs._replace(which={"bilinear": 0, "dy": 2}.get(mode, 1),
                     env_aniso=4 if mode == "probes" else 1)
    assert fs.mode() == mode
    rows = torch.full((fs.n_tiles(), 1 + 3 * fs.phases()), -1, dtype=torch.long, device=cuda_device)
    kc, kn = fk.frame_kernel(packed, uni, jit, fs, tile_rows=rows)
    pc, pn = fk.frame_plain(packed, uni, jit, fs)
    torch.cuda.synchronize()
    assert torch.equal(rows.sum(0), kn)
    assert chip_smoke.frame_disagreement(kc, kn.cpu(), pc, pn.cpu()) is None
    info = fk.launch_info(packed.stack_depth, mode)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["which1", "k3-ragged", "given-raygen"])
def test_frame_kernel_every_launch_shape_on_card(cuda_device, name):
    """Under each tile shape and warp map the kernel's colour and counter
    row are the default launch's bit for bit; its tile rows sum to the row
    and agree with the plain version's at that shape; a width it has not
    is refused with CUDA's invalid-argument error."""
    from shader_ray_tpu_torch.ops import frame_kernel as fk

    packed, uni, jit, fs, rays = chip_smoke.frame_case(name, cuda_device)
    colour, row = fk.frame_kernel(packed, uni, jit, fs, rays=rays)
    for tile_w, warp_map in chip_smoke.FRAME_SHAPES:
        s = fs._replace(tile_w=tile_w, warp_map=warp_map)
        rows = torch.full((s.n_tiles(), 1 + 3 * s.phases()), -1, dtype=torch.long, device=cuda_device)
        prows = torch.empty_like(rows)
        kc, kn = fk.frame_kernel(packed, uni, jit, s, tile_rows=rows, rays=rays)
        fk.frame_plain(packed, uni, jit, s, tile_rows=prows, rays=rays)
        torch.cuda.synchronize()
        assert torch.equal(chip_smoke.bits(kc), chip_smoke.bits(colour)) and torch.equal(kn, row)
        assert torch.equal(rows.sum(0), kn)
        assert chip_smoke.tile_rows_disagreement(rows.cpu(), prows.cpu()) is None
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fk.frame_kernel(packed, uni, jit, fs._replace(tile_w=12), rays=rays)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fk.frame_kernel(packed, uni, jit, fs._replace(warp_map="columns"), rays=rays)
    info = fk.launch_info(packed.stack_depth, fs.mode(), rays is not None, tile_w=64,
                          warp_map="bricks")
    assert (info["tile_w"], info["tile_h"], info["local_bytes"]) == (64, 4, 0)


def test_tile_rows_gate_refuses_a_wrong_pixel_map():
    """chip_smoke.tile_rows_disagreement passes a flipped ray's tile and
    refuses rows binned by another map."""
    rng = np.random.default_rng(3)
    per_pixel = torch.from_numpy(rng.integers(0, 50, (48, 64, 4)))
    rows = per_pixel.reshape(3, 16, 4, 16, 4).sum((1, 3)).reshape(12, 4)
    flipped = rows.clone()
    flipped[5, 0] += 1
    flipped[5, 1:] += 7
    assert chip_smoke.tile_rows_disagreement(flipped, rows) is None
    transposed = per_pixel.reshape(3, 16, 4, 16, 4).sum((3, 1)).transpose(0, 1).reshape(12, 4)
    assert chip_smoke.tile_rows_disagreement(transposed, rows) is not None
    assert chip_smoke.tile_rows_disagreement(rows[:6], rows) is not None


@functools.cache
def _trace_case_scene():
    """A 2000-triangle bench-like scene as wide and binary tables, and
    1024 seeded rays (8 blocks of chip_smoke.TRACE_BLOCK) from in front of
    it toward points inside its box."""
    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops.pack import pack_scene
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide

    pos, nrm = bunny_class_scene(2000)
    data = get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm)))
    rng = np.random.default_rng(12)
    P = (np.array([0.0, 0.0, 3.8]) + rng.uniform(-0.3, 0.3, (1024, 3))).astype(np.float32)
    D = rng.uniform(-0.8, 0.8, (1024, 3)).astype(np.float32) - P
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    tables = {"wide": pack_scene_wide(data, procedural_sky(32)),
              "binary": pack_scene(data, procedural_sky(32))}
    return tables, torch.from_numpy(P), torch.from_numpy(D)


@pytest.mark.parametrize("name", chip_smoke.TRACE_CASES)
def test_trace_cases_show_their_paths(name):
    """Each case of the trace kernels' masks and layouts, walked by both
    plain versions on the CPU for the closest and any hit, shows the path
    it is for: no ray active, all, one ray a block, every other warp, a
    seeded 3%, a ray count that ends inside a block, a 31 x 23 image;
    active rays walk and the rest do not."""
    from shader_ray_tpu_torch.ops.trace_kernel import trace

    tables, P, D = _trace_case_scene()
    P, D, active, width = chip_smoke.trace_case(name, P, D)
    for packed in tables.values():
        for any_hit in (False, True):
            hit = trace(packed, P, D, active, any_hit=any_hit, with_stats=True, width=width)
            assert chip_smoke.trace_case_unmet(name, active, hit.stats[:, 0]) is None
            assert (hit.t[active] < 1.0e7).any() == (name != "none")


@pytest.mark.parametrize("name", chip_smoke.TRACE_CASES)
def test_trace_case_check_refuses_a_walk_off_its_path(name):
    """Each case's check refuses an active mask or per-ray steps that are
    not the case's path, so a kernel that walks the wrong rays fails on
    the card."""
    _, P, D = _trace_case_scene()
    P, D, active, _ = chip_smoke.trace_case(name, P, D)
    steps = active.long() * 5
    assert chip_smoke.trace_case_unmet(name, active, steps) is None
    idle = torch.nonzero(~active).squeeze(1)
    if idle.numel():
        wrong = steps.clone()
        wrong[idle[-1]] = 1                          # an inactive ray walked
        assert chip_smoke.trace_case_unmet(name, active, wrong) is not None
    if active.any():
        wrong = steps.clone()
        wrong[torch.nonzero(active)[0, 0]] = 0        # an active ray did not
        assert chip_smoke.trace_case_unmet(name, active, wrong) is not None
    # the complement of the case's mask, walked as asked
    assert chip_smoke.trace_case_unmet(name, ~active, (~active).long()) is not None


@pytest.mark.parametrize("fault", ["t", "hit-flips", "ids", "bad", "counters", "normals",
                                   "idle-work", "idle-hit"])
def test_trace_gate_refuses_each_fault(fault):
    """chip_smoke's gate of a trace kernel's result against its plain
    version passes differences inside its limits (t off by 1e-6 of its
    scale on every ray, normals by 1e-6, a walk counter by 1e-4 of its
    total) and refuses each kind beyond them."""
    from shader_ray_tpu_torch.ops.trace_kernel import trace

    tables, P, D = _trace_case_scene()
    active = torch.from_numpy(np.random.default_rng(3).uniform(size=P.shape[0]) < 0.7)
    want = trace(tables["wide"], P, D, active, with_stats=True)
    hits = torch.nonzero(want.t < 1.0e7).squeeze(1)
    assert hits.numel() > 200
    near = want._replace(t=torch.where(want.t < 1.0e7, want.t * (1 + 1e-6), want.t),
                         normal=want.normal + 1e-6 * active[:, None], stats=want.stats.clone())
    near.stats[hits[0], 2] += int(1e-4 * float(want.stats[:, 2].sum()))
    assert chip_smoke.trace_disagreement(near, want, active, False)[1] is None
    got = want._replace(t=want.t.clone(), which=want.which.clone(), normal=want.normal.clone(),
                        bad=want.bad.clone(), stats=want.stats.clone())
    some = hits[: max(hits.numel() // 50, 2)]
    idle = torch.nonzero(~active)[0, 0]
    if fault == "t":
        got.t[hits] += 1e-3
    elif fault == "hit-flips":
        got.t[some], got.which[some] = 1.0e7, -1
    elif fault == "ids":
        got.which[some] += 1
        got.t[some] *= 1 + 2e-6                     # no tie: another triangle
    elif fault == "bad":
        got.bad[hits[0]] = True
    elif fault == "counters":
        got.stats[active, 2] += 1                   # a test more a ray
    elif fault == "normals":
        got.normal[hits] += 1e-4
    elif fault == "idle-work":
        got.stats[idle, 0] = 1
    else:
        got.t[idle] = 1.0
    assert chip_smoke.trace_disagreement(got, want, active, False)[1] is not None


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.TRACE_CASES)
def test_trace_cases_on_card(cuda_device, name):
    """Both trace kernels against their plain versions on each case of
    their masks and layouts, closest and any hit, under chip_smoke's gate (t, ids, normals,
    bad flags, each walk counter total within 1e-3, inactive rays a miss
    with no work), and each case's walk on its path."""
    from shader_ray_tpu_torch.ops import trace_kernel as tk

    tables, P, D = _trace_case_scene()
    P, D, active, width = chip_smoke.trace_case(name, P, D)
    P, D, active = (x.to(cuda_device) for x in (P, D, active))
    for kind, packed in tables.items():
        packed = packed.to(cuda_device)
        plain = tk.walk_plain if kind == "wide" else tk.walk_binary_plain
        for any_hit in (False, True):
            before = tk._build.LAUNCHES[f"trace_{kind}"]
            got = tk.trace(packed, P, D, active, any_hit=any_hit, with_stats=True, width=width)
            assert tk._build.LAUNCHES[f"trace_{kind}"] == before + 1
            walk = plain(packed, P, D, active, any_hit)
            torch.cuda.synchronize()
            assert chip_smoke.trace_disagreement(got, tk.packet_hit(walk, True), active,
                                                 any_hit)[1] is None
            assert chip_smoke.trace_case_unmet(name, active.cpu(), got.stats[:, 0].cpu()) is None


NEW_MODULES = ("shader_ray_tpu_torch.parallel", "shader_ray_tpu_torch.parallel.mesh",
               "shader_ray_tpu_torch.native", "shader_ray_tpu_torch.models.quality",
               "shader_ray_tpu_torch.utils.kerneldiag", "shader_ray_tpu_torch.utils.profiling",
               "shader_ray_tpu_torch.ops.reference")


def test_new_modules_are_walked_and_stand_alone():
    """The mesh, native-builder, quality, diagnostics, profiling and
    brute-force oracle modules are among those the import test loads, and the native builder compiles
    the port's own copy of libscene.cpp into the port's build directory,
    never the reference's native/."""
    from shader_ray_tpu_torch import native

    walked = {m.name for m in pkgutil.walk_packages(shader_ray_tpu_torch.__path__,
                                                    "shader_ray_tpu_torch.")}
    assert set(NEW_MODULES) <= walked
    assert native.SOURCE.is_relative_to(PKG) and native._path().is_relative_to(PKG)
    assert native.SOURCE.read_bytes() == open(os.path.join(ROOT, "native", "libscene.cpp"), "rb").read()


def _bench_like(device, n_tris=5000, mesh=None, **knobs):
    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.engine import Renderer
    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops.render import default_frame_params
    from shader_ray_tpu_torch.utils import mat4

    data = get_shader_data(make_world(TriangleSet.from_arrays(*bunny_class_scene(n_tris))))
    renderer = Renderer(data, procedural_sky(256), Config(**knobs), device=device, mesh=mesh)
    params = default_frame_params()._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0.0, 0.0, 3.8)),
        diffuse_color=torch.tensor([0.8, 0.2, 0.2]))
    return renderer, params


def test_native_build_equals_numpy_here():
    """Native and numpy SceneData on this host (the card's host too:
    -march=native differs there), every array byte for byte."""
    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world

    ts = TriangleSet.from_arrays(*bunny_class_scene(5000))
    a = get_shader_data(make_world(ts, Config(use_native="require")))
    b = get_shader_data(make_world(ts, Config(use_native="never")))
    for f in ("tri_positions", "tri_normals", "node_boxes", "node_objects", "node_children", "hitmiss"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert (a.tree_root, a.triangle_count, a.group_count) == (b.tree_root, b.triangle_count,
                                                              b.group_count)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [{}, {"packet_fused": False}, {"packet_kernel": "binary"}])
def test_sharded_frame_equals_given_rays_frame_on_card(cuda_device, knobs):
    """Two shards on the one card: the gathered frame is the unsharded
    given-rays frame bit for bit (the card computes each element alone)."""
    from shader_ray_tpu_torch.ops import engine_frame as ef
    from shader_ray_tpu_torch.ops.render import RenderStatics

    one, params = _bench_like(cuda_device, **knobs)
    two, _ = _bench_like(cuda_device, mesh=[cuda_device, cuda_device], **knobs)
    for which in (0, 1, 5):
        statics = RenderStatics(width=96, height=37, which=which, env_aniso=4, do_tonemap=False)
        want = ef.render_linear(one.packed, params, statics, ef.frame_jitter(params), 0, one.fused,
                                0.0, rows=(0, statics.height))
        got = two.make_fn(statics)(params)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (knobs, which)


@pytest.mark.cuda
def test_forced_launch_failure_dumps_on_card(cuda_device, capsys, monkeypatch):
    """The kernel's C entry refuses bounce_count = -1: the Renderer's
    function prints the dump naming frame_kernel and re-raises."""
    from shader_ray_tpu_torch.ops.render import RenderStatics

    monkeypatch.delenv("SRT_KERNEL_DIAG", raising=False)
    r, params = _bench_like(cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error 1 .invalid argument."):
        r.make_fn(RenderStatics(width=32, height=32, bounce_count=-1))(params)
    err = capsys.readouterr().err
    assert "kernel: frame_kernel" in err and "bounce_count=-1" in err and "device: cuda" in err
    frame = r.make_fn(RenderStatics(width=32, height=32))(params)  # the context lives on
    assert torch.isfinite(frame).all()


@pytest.mark.cuda
def test_debug_nans_and_device_trace_on_card(cuda_device, tmp_path):
    from shader_ray_tpu_torch.ops.render import RenderStatics
    from shader_ray_tpu_torch.utils.profiling import device_trace

    r, params = _bench_like(cuda_device, debug_nans=True)
    up = torch.tensor([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=torch.float32)
    with pytest.raises(FloatingPointError, match="NaN"):
        r.make_fn(RenderStatics(width=32, height=32, which=1, env_aniso=4))(
            params._replace(camera_normal_matrix=up, pixel_jitter=torch.tensor([0.5, 0.5])))
    statics = RenderStatics(width=64, height=64)
    with device_trace(str(tmp_path)):
        r.make_fn(statics)(params)
    (trace,) = os.listdir(tmp_path)
    assert '"frame_kernel"' in (tmp_path / trace).read_text()


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.FRAME_CASES)
def test_mt_frame_kernel_control_flow_on_card(cuda_device, name):
    """The Moller-Trumbore instantiations of the frame kernel
    (Config.leaf_isect="mt") against frame_plain on chip_smoke's
    FRAME_CASES, under the Woop form's limits, counted as frame_kernel_mt."""
    from shader_ray_tpu_torch.ops import frame_kernel as fk

    packed, uni, jit, fs, rays = chip_smoke.frame_case(name, cuda_device, "mt")
    assert packed.isect == "mt"
    before = dict(fk._build.LAUNCHES)
    kc, kn = fk.frame_kernel(packed, uni, jit, fs, rays=rays)
    assert fk._build.LAUNCHES["frame_kernel_mt"] == before.get("frame_kernel_mt", 0) + 1
    assert fk._build.LAUNCHES["frame_kernel"] == before.get("frame_kernel", 0)
    pc, pn = fk.frame_plain(packed, uni, jit, fs, rays=rays)
    torch.cuda.synchronize()
    assert chip_smoke.frame_disagreement(kc, kn.cpu(), pc, pn.cpu()) is None
    assert chip_smoke.case_unmet(name, fs, kc, kn.cpu(), "mt") is None
    info = fk.launch_info(packed.stack_depth, fs.mode(), rays is not None, "mt")
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_mt_trace_kernel_matches_plain_and_oracle_on_card(cuda_device, any_hit):
    """trace_wide's Moller-Trumbore instantiation against walk_plain (mt)
    under the limits of test_trace_kernel_matches_plain_on_card, and its
    closest hits against the brute-force oracle ops/reference
    (chip_smoke.oracle_disagreement)."""
    from shader_ray_tpu_torch.ops import trace_kernel as tk
    from shader_ray_tpu_torch.ops.reference import intersect_brute

    packed = _card_scene(cuda_device, "wide", "mt")
    rng = np.random.default_rng(32)
    P = torch.from_numpy(rng.uniform(-1.6, 1.6, (4096, 3)).astype(np.float32)).to(cuda_device)
    D = rng.normal(size=(4096, 3)).astype(np.float32)
    D[:64] = [0.0, 0.0, 1.0]
    D = torch.from_numpy(D / np.linalg.norm(D, axis=1, keepdims=True)).to(cuda_device)
    active = torch.ones(4096, dtype=torch.bool, device=cuda_device)
    before = tk._build.LAUNCHES["trace_wide_mt"]
    got = tk.trace_wide(packed, P, D, active, any_hit=any_hit, with_stats=True)
    assert tk._build.LAUNCHES["trace_wide_mt"] == before + 1
    want = tk.packet_hit(tk.walk_plain(packed, P, D, active, any_hit), True)
    torch.cuda.synchronize()
    assert chip_smoke.trace_disagreement(got, want, active, any_hit)[1] is None
    info = tk.launch_info("trace_wide", packed.stack_depth, "mt")
    assert info["local_bytes"] == 512 and info["blocks_per_sm"] >= 4
    if not any_hit:
        tris = torch.from_numpy(_card_data().tri_positions.reshape(-1, 3, 3)).to(cuda_device)
        e, why = chip_smoke.oracle_disagreement(got, intersect_brute(tris, P, D), tris, P, D)
        assert why is None, e
        assert e["hits"] > 500


@pytest.mark.parametrize("fault", [None, "id", "flip", "t"])
def test_oracle_gate_refuses_each_fault(fault):
    """chip_smoke's oracle gate on the CPU: the mt plain walk's closest hits
    pass against ops/reference.intersect_brute on the trace cases' rays,
    and each fault fails it: another triangle than the oracle's nearest
    (not tied), a hit turned into a miss away from any edge, t off by 1e-5
    relative."""
    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky
    from shader_ray_tpu_torch.models.triangle_set import TriangleSet
    from shader_ray_tpu_torch.models.world import get_shader_data, make_world
    from shader_ray_tpu_torch.ops import trace_kernel as tk
    from shader_ray_tpu_torch.ops.pack_wide import pack_scene_wide
    from shader_ray_tpu_torch.ops.reference import intersect_brute

    data = get_shader_data(make_world(TriangleSet.from_arrays(*bunny_class_scene(2000))))
    packed = pack_scene_wide(data, procedural_sky(32), Config(leaf_isect="mt"))
    _, P, D = _trace_case_scene()
    tris = torch.from_numpy(data.tri_positions.reshape(-1, 3, 3))
    want = intersect_brute(tris, P, D)
    got = tk.trace_wide(packed, P, D)
    t_b, w_b, u_b, v_b = want
    slack = torch.minimum(torch.minimum(u_b, v_b), 1.0 - u_b - v_b)
    inner = torch.nonzero((t_b < 1e7) & (slack > 0.05)).squeeze(1)
    assert inner.numel() > 100
    r = int(inner[0])
    if fault == "id":
        got.which[r] = (int(w_b[r]) + tris.shape[0] // 2) % tris.shape[0]
    elif fault == "flip":
        got.t[r], got.which[r] = tk.INFINITELY_FAR, -1
    elif fault == "t":
        got.t[r] = t_b[r] * (1.0 + 1e-5)
    e, why = chip_smoke.oracle_disagreement(got, want, tris, P, D)
    assert (why is None) == (fault is None), (fault, e, why)
