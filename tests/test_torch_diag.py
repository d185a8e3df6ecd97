"""The failure dump, ``Config.debug_nans`` and the profiling helpers on the
CPU.  A kernel build forced to fail (no nvcc, the tensors' device
reported as the card) inside a Renderer function prints
``describe_failure``, naming the kernel, its settings, the packed
tables' shapes, the device and a hint, and re-raises; the launch
errors' names select their hints; ``suppress`` and ``SRT_KERNEL_DIAG=0``
silence the dump only where they apply.  Under ``debug_nans`` a grad-mode
frame with a ray exactly along +y (NaN, as in the reference) raises
``FloatingPointError`` naming the function, while a normal frame and a
frame painted red by the walk budget do not.  ``device_trace`` (a
torch.profiler trace whose kernel ranges carry the wrappers' names)
works; ``Config.from_env`` reads ``SRT_NATIVE``,
``SRT_COLLAPSE`` and ``SRT_DEBUG_NANS`` as the reference's does."""

import contextlib
import dataclasses
import json
import os

import pytest
import torch

from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.models.fixtures import procedural_sky, uv_sphere
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.ops import _build
from shader_ray_tpu_torch.ops.render import RenderStatics, default_frame_params
from shader_ray_tpu_torch.ops.shading import filmic
from shader_ray_tpu_torch.utils import kerneldiag, mat4, profiling
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 32  # even: at jitter (0.5, 0.5) pixel (N/2 - 1, N/2 - 1)'s ray is the view axis


@pytest.fixture(scope="module")
def sphere():
    pos, nrm = uv_sphere(lat=8, lon=12)
    data = get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm)))
    params = default_frame_params()._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0.0, 0.0, 3.2)),
        diffuse_color=torch.tensor([0.8, 0.2, 0.2]),
    )
    return data, procedural_sky(128), params


@pytest.fixture
def no_nvcc(monkeypatch):
    """The kernels cannot build, and every tensor reports the card."""
    def missing():
        raise RuntimeError("nvcc not found: the kernels build with the CUDA toolkit")

    monkeypatch.setattr(_build, "_nvcc", missing)
    monkeypatch.setattr(_build, "one_device", lambda where, tensors: torch.device("cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    monkeypatch.delenv("SRT_KERNEL_DIAG", raising=False)


def test_forced_build_failure_dumps_and_reraises(sphere, no_nvcc, capsys):
    data, env, params = sphere
    r = Renderer(data, env, device="cpu")
    statics = RenderStatics(width=24, height=16, which=1, env_aniso=4)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        r.make_fn(statics)(params)
    err = capsys.readouterr().err
    assert "=== kernel failure (frame fn) ===" in err
    assert "kernel: frame_kernel" in err
    assert "settings: width=24, height=16" in err and "which=1" in err and "env_aniso=4" in err
    assert f"nodes({r.packed.n_wide}, 8, 8)" in err and f"stack_depth={r.packed.stack_depth}" in err
    assert "device: cpu" in err and "hint: the CUDA toolkit is missing" in err
    # the unfused route: a trace kernel, the trace settings
    u = Renderer(data, env, Config(packet_fused=False), device="cpu")
    with pytest.raises(RuntimeError):
        u.make_progressive_fn(RenderStatics(width=8, height=8), 2)(params)
    err = capsys.readouterr().err
    assert "progressive fn (K=2)" in err and "kernel: trace_wide" in err
    assert "route='unfused'" in err and "tables='PackedWide'" in err
    b = Renderer(data, env, Config(packet_kernel="binary"), device="cpu")
    with pytest.raises(RuntimeError):
        b.make_count_fn(RenderStatics(width=8, height=8))(params)
    err = capsys.readouterr().err
    assert "cast-count fn" in err and "kernel: trace_binary" in err and "tris(" in err


@pytest.mark.parametrize("code,hint", [
    (701, "more registers or shared memory"), (209, "another architecture"),
    (700, "CUDA_LAUNCH_BLOCKING=1"), (1, "refused its arguments"), (2, "memory exhausted"),
])
def test_launch_errors_are_named_and_hinted(code, hint):
    with pytest.raises(RuntimeError) as info:
        _build.launched("frame_kernel", code)
    assert _build.CUDA_ERRORS[code] in str(info.value)
    msg = kerneldiag.describe_failure(info.value, label="frame fn")
    assert f"CUDA error {code}" in msg and hint in msg
    assert kerneldiag.describe_failure(RuntimeError("nvcc failed building env_kernel.cu"))\
        .count("hint: nvcc refused")


def test_suppress_is_scoped(capsys, monkeypatch):
    monkeypatch.delenv("SRT_KERNEL_DIAG", raising=False)
    with kerneldiag.suppress():
        with kerneldiag.suppress():
            kerneldiag.report_failure(RuntimeError("boom"))
        kerneldiag.report_failure(RuntimeError("boom"))
    assert "kernel failure" not in capsys.readouterr().err
    kerneldiag.report_failure(RuntimeError("boom"))
    assert "kernel failure" in capsys.readouterr().err
    try:
        with kerneldiag.suppress():
            raise ValueError("inside")
    except ValueError:
        pass
    kerneldiag.report_failure(RuntimeError("boom"))  # the scope ended with the error
    assert "kernel failure" in capsys.readouterr().err
    monkeypatch.setenv("SRT_KERNEL_DIAG", "0")
    kerneldiag.report_failure(RuntimeError("boom"))
    assert capsys.readouterr().err == ""


def _up_params(params):
    """The camera looks up +y; at the jitter (0.5, 0.5) the centre
    pixel's ray is exactly (0, 1, 0) and misses the sphere."""
    up = torch.tensor([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=torch.float32)
    return params._replace(camera_normal_matrix=up, pixel_jitter=torch.tensor([0.5, 0.5]))


@pytest.mark.parametrize("route", [{}, {"packet_fused": False}])
def test_debug_nans_raises_on_the_y_axis_grad_frame(sphere, route):
    data, env, params = sphere
    statics = RenderStatics(width=N, height=N, which=1, env_aniso=4)
    quiet = Renderer(data, env, Config(**route), device="cpu")
    frame = quiet.make_fn(statics)(_up_params(params))
    assert int(torch.isnan(frame).any(-1).sum()) == 1  # NaN, as in the reference
    loud = Renderer(data, env, Config(debug_nans=True, **route), device="cpu")
    with pytest.raises(FloatingPointError, match="frame fn: NaN in its output"):
        loud.make_fn(statics)(_up_params(params))
    with pytest.raises(FloatingPointError, match="frame fn"):
        loud.make_checksum_fn(statics)(_up_params(params))
    # silent on the same camera at which = 0, and on the usual view
    assert torch.isfinite(loud.make_fn(statics._replace(which=0))(_up_params(params))).all()
    assert torch.isfinite(loud.make_fn(statics)(params)).all()


def test_debug_nans_is_read_at_each_call_and_ignores_red_paint(sphere):
    data, env, params = sphere
    statics = RenderStatics(width=N, height=N, which=1, env_aniso=4)
    r = Renderer(data, env, device="cpu")
    fn = r.make_fn(statics)
    fn(_up_params(params))
    r.cfg.debug_nans = True  # as the REPL's `set debug_nans 1` does
    with pytest.raises(FloatingPointError):
        fn(_up_params(params))
    # one node pop a walk: rays that must descend are painted red, not NaN
    tight = Renderer(data, env, Config(packet_max_steps=1, debug_nans=True), device="cpu")
    img = tight.make_fn(RenderStatics(width=N, height=N))(params)
    red = filmic(torch.tensor([1.0, 0.0, 0.0]))
    assert bool(((img - red).abs() < 1e-6).all(-1).any())


def test_device_trace_names_the_kernel_ranges(tmp_path, sphere):
    data, env, params = sphere
    logdir = tmp_path / "trace"
    with profiling.device_trace(str(logdir)):
        with profiling.span("frame_kernel"):
            Renderer(data, env, device="cpu").make_fn(RenderStatics(width=8, height=8))(params)
    (trace,) = os.listdir(logdir)
    events = json.loads((logdir / trace).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "frame_kernel" in names and any(str(n).startswith("aten::") for n in names)
    # outside a trace, a launch opens no range
    assert isinstance(profiling.span("frame_kernel"), contextlib.nullcontext)


def test_config_from_env_reads_the_new_variables_as_the_reference(monkeypatch):
    for env in ({"SRT_NATIVE": "never", "SRT_COLLAPSE": "greedy", "SRT_DEBUG_NANS": "1"},
                {"SRT_NATIVE": "require"}, {"SRT_DEBUG_NANS": ""}):
        for k in ("SRT_NATIVE", "SRT_COLLAPSE", "SRT_DEBUG_NANS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        port, ref = Config.from_env(), RefConfig.from_env()
        for f in ("use_native", "collapse", "debug_nans"):
            assert getattr(port, f) == getattr(ref, f), (env, f)
    assert Config.from_env().debug_nans and Config.from_env().use_native == "auto"
    monkeypatch.setenv("SRT_COLLAPSE", "binary")
    with pytest.raises(ValueError, match="collapse"):
        Config.from_env()
    assert {f.name for f in dataclasses.fields(Config)} >= {"use_native", "collapse", "debug_nans"}
