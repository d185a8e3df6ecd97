"""Multi-device rendering on the CPU (shader_ray_tpu_torch/parallel/):
meshes of n CPU shards, n = 1 to 4, on the sphere fixture, through the
Renderer's entry points.

Ray sharding: a frame of a height no n divides (37 rows) is the
unsharded frame of the same rays (``render_linear(rows=(0, H))``: on the
fused route the frame kernel's given-rays form over ``raygen_rays``, as
the reference turns in-kernel raygen off under a mesh) bit for bit, for
``which`` 0, 1 (aniso 4), 3 and 5, on wide tables fused and unfused and
on binary tables.  The frames are 64 pixels wide: PyTorch's CPU kernels
compute ``pow`` and ``atan2`` in vector lanes and in a scalar tail whose
results differ in the last bit, so on the CPU a ray's colour depends on
its position modulo the vector width (up to 32 floats); with 64-ray rows
every band starts on a vector boundary, as the whole frame's rows do.  A
48-pixel frame is held to the same frame within 1e-6 of its magnitude.
The card computes each element alone, and chip_smoke.py holds the
sharded frame to the unsharded one bit for bit there at 1024 x 768.

Sample sharding: K = 8 jitters over n = 2 and 4 devices, the n linear
means summed and divided by n, within 1e-6 (max abs, linear) of the
unsharded K = 8 mean; K = 6 over 4 devices shards the rays instead.

The CLI's ``--devices``: N CPU shards with ``--device cpu``; on a
machine of one card N = 2 is refused with both numbers named."""

import numpy as np
import pytest
import torch

from shader_ray_tpu_torch.app import main as app_main
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.models.fixtures import procedural_sky, uv_sphere
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.ops import engine_frame as ef
from shader_ray_tpu_torch.ops.render import RenderStatics, default_frame_params
from shader_ray_tpu_torch.parallel import make_mesh, replicate_scene, row_bands
from shader_ray_tpu_torch.utils import mat4
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 64, 37
ROUTES = {"fused": {}, "unfused": {"packet_fused": False}, "binary": {"packet_kernel": "binary"}}
# (route, which, env_aniso, height): which = 5 traces 25 sets, so a shorter frame
CASES = [("fused", 0, 1, H), ("fused", 1, 4, H), ("fused", 3, 1, H), ("fused", 5, 1, 13),
         ("unfused", 0, 1, H), ("unfused", 1, 4, H), ("binary", 0, 1, H)]


@pytest.fixture(scope="module")
def scene():
    pos, nrm = uv_sphere(lat=12, lon=16)
    data = get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm)))
    params = default_frame_params()._replace(
        camera_matrix=torch.from_numpy(mat4.make_translation(0.0, 0.0, 3.2)),
        light_dir=torch.tensor([0.36, 0.48, 0.8]),
        diffuse_color=torch.tensor([0.8, 0.2, 0.2]),
        specular_color=torch.tensor([0.3, 0.3, 0.3]),
        pixel_jitter=torch.tensor([0.25, -0.1]),
    )
    return data, procedural_sky(256), params


def _unsharded(renderer, params, statics):
    """The whole frame's given-rays form on one device, linear."""
    return ef.render_linear(renderer.packed, params, statics, ef.frame_jitter(params),
                            renderer.cfg, rows=(0, statics.height))


def test_row_bands_cover_the_rows_once():
    for height in (1, 2, 13, 37, 768):
        for n in range(1, 6):
            bands = row_bands(height, n)
            assert len(bands) == n and bands[0][0] == 0 and bands[-1][1] == height
            assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
            sizes = [r1 - r0 for r0, r1 in bands]
            assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


def test_make_mesh_and_replicas(monkeypatch):
    assert make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        make_mesh([])
    # "cuda" is the current card's: the same device as "cuda:0" there
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert make_mesh(["cuda", "cuda:0"]) == [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="not the mesh's first device"):
        Renderer(None, None, device="cpu", mesh=["cuda", "cuda"])

    class Tables:
        def to(self, device):
            return ("copy on", device)

    cpu = torch.device("cpu")
    assert replicate_scene(Tables(), [cpu] * 3) == {cpu: ("copy on", cpu)}  # one a device


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("route,which,aniso,height", CASES)
def test_ray_sharded_frame_is_bit_identical(scene, route, which, aniso, height, n):
    data, env, params = scene
    statics = RenderStatics(width=W, height=height, which=which, env_aniso=aniso, do_tonemap=False)
    cfg = Config(**ROUTES[route])
    want = _unsharded(Renderer(data, env, cfg, device="cpu"), params, statics)
    got = Renderer(data, env, cfg, mesh=["cpu"] * n).make_fn(statics)(params)
    assert got.shape == (height, W, 3) and got.std() > 1e-3
    assert torch.equal(got, want)


def test_ray_sharded_frame_off_the_vector_width(scene):
    """48-pixel rows: a band may start inside a vector of the whole
    frame's, so pow and atan2 may differ in the last bit (module
    docstring); the frames agree within 1e-6 of their magnitude."""
    data, env, params = scene
    statics = RenderStatics(width=48, height=H, do_tonemap=False)
    for cfg in (Config(), Config(packet_fused=False)):
        want = _unsharded(Renderer(data, env, cfg, device="cpu"), params, statics)
        for n in (2, 3):
            got = Renderer(data, env, cfg, mesh=["cpu"] * n).make_fn(statics)(params)
            assert float((got - want).abs().max()) <= 1e-6 * max(1.0, float(want.abs().max()))


def test_sharded_tonemapped_frame_and_checksum(scene):
    data, env, params = scene
    statics = RenderStatics(width=W, height=H)
    r = Renderer(data, env, mesh=["cpu"] * 3)
    one = Renderer(data, env, device="cpu")
    frame = r.make_fn(statics)(params)
    assert torch.equal(frame, ef.finish(_unsharded(one, params, statics), statics))
    assert torch.equal(r.make_checksum_fn(statics)(params), frame.sum())
    # the raygen frame on one device: the kernel's own raygen, the same rays
    assert float((frame - one.make_fn(statics)(params)).abs().max()) <= 1e-6
    # count and stats stay on mesh[0]
    assert r.make_count_fn(statics)(params) == one.make_count_fn(statics)(params)
    assert torch.equal(r.make_stats_fn(statics)(params), one.make_stats_fn(statics)(params))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_sample_sharded_progressive_within_1e6(scene, route, n):
    data, env, params = scene
    linear = RenderStatics(width=W, height=H, do_tonemap=False)
    cfg = Config(**ROUTES[route])
    want = Renderer(data, env, cfg, device="cpu").make_progressive_fn(linear, 8)(params)
    fn = Renderer(data, env, cfg, mesh=["cpu"] * n).make_progressive_fn(linear, 8)
    got = fn(params)
    assert float((got - want).abs().max()) <= 1e-6
    assert float((got - Renderer(data, env, cfg, device="cpu").make_fn(linear)(params))
                 .abs().mean()) > 1e-5  # a mean of 8 samples, not one frame


def test_progressive_shards_rays_when_samples_do_not_split(scene):
    data, env, params = scene
    linear = RenderStatics(width=W, height=H, do_tonemap=False)
    jitters = torch.from_numpy(ef.halton_jitters(6))
    one = Renderer(data, env, device="cpu")
    want = ef.render_linear(one.packed, params, linear, jitters, Config(), rows=(0, H))
    got = Renderer(data, env, mesh=["cpu"] * 4).make_progressive_fn(linear, 6)(params)
    assert torch.equal(got, want)
    tonemapped = Renderer(data, env, mesh=["cpu"] * 4).make_progressive_fn(
        linear._replace(do_tonemap=True), 6, reduce_sum=True)(params)
    assert torch.equal(tonemapped, ef.finish(want, linear._replace(do_tonemap=True)).sum())


def test_cli_mesh_of_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert app_main.cli_mesh(1, cpu) is None
    assert app_main.cli_mesh(3, cpu) == ["cpu"] * 3
    with pytest.raises(RuntimeError, match="--devices -1"):
        app_main.cli_mesh(-1, cpu)
    # a machine of one card: 1 and 0 (all) give no mesh, 2 is refused
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = torch.device("cuda", 0)
    assert app_main.cli_mesh(1, card) is None and app_main.cli_mesh(0, card) is None
    with pytest.raises(RuntimeError, match=r"2 device\(s\) asked for, but this machine has 1"):
        app_main.cli_mesh(2, card)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert app_main.cli_mesh(0, card) == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_cli_refuses_more_devices_than_cards(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = app_main.main([str(tmp_path / "never-read.obj"), "grid", "--devices", "2", "--once",
                        "--out", str(tmp_path / "f.ppm")])
    err = capsys.readouterr().err
    assert rc == 1 and "2 device(s) asked for, but this machine has 1 CUDA device(s)" in err
    assert not (tmp_path / "f.ppm").exists()


def test_cli_renders_on_cpu_shards(tmp_path, monkeypatch, capsys):
    from shader_ray_tpu_torch.models.trisrc import write_trisrc
    from shader_ray_tpu_torch.utils.ppm import read_ppm

    pos, nrm = uv_sphere(lat=4, lon=6)
    write_trisrc(str(tmp_path / "tri.trisrc"), pos, nrm)
    monkeypatch.setenv("SRT_CACHE_DIR", str(tmp_path / "cache"))
    frames = []
    for devices in ("1", "3"):
        out = str(tmp_path / f"f{devices}.ppm")
        assert app_main.main([str(tmp_path / "tri.trisrc"), "0.2, 0.3, 0.4", "--width", "16",
                              "--height", "11", "--once", "--device", "cpu", "--devices", devices,
                              "--out", out]) == 0
        frames.append(read_ppm(out))
    assert "mesh of 3" in capsys.readouterr().err
    assert frames[0].shape == (11, 16, 3) and frames[0].std() > 0
    # the raygen frame and the sharded given-rays frame, 8 bits a channel
    assert np.abs(frames[0].astype(int) - frames[1].astype(int)).max() <= 1
