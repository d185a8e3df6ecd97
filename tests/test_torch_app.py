"""The port's host modules and app layer against the JAX package's, on the
same inputs: ``Config`` (defaults, ``from_env``), ``RenderStatics.
from_config``, the trisrc and OBJ parsers (the reference's Python
parsers, ``use_native="never"``), ``load_background``, ``load_world``,
PPM and ANSI output, the camera and materials functions; then the
``App`` and the CLI.

The App: a REPL script is fed to the port's ``repl()`` on
``Renderer(device="cpu")`` at 32 x 32; the reference's ``App`` takes the
same commands through its methods, and the two hold the same state
(matrices, ``which``, material, fov, light, ``cfg.min_contrib``) after
every command.  Frames are compared only at ``which`` 0 and 5, at the
frame tolerance of tests/test_torch_unfused.py (mean abs < 2e-3, >= 99%
of pixels within 2e-2): the reference's ``which = 0`` frame is its App's
(wavefront engine); its ``which = 5`` frame is the reference's
``trace_rays`` over the 25 sub-sample rays of its App's params, traced by
one jitted function, because its App compiles the 25 traces of that mode
into one program for ~40 s on this host.  The port renders each ray
exactly, as the wavefront engine does, so the ``grid`` env shows its
lattice here too."""

import dataclasses
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shader_ray_tpu.app import camera as ref_camera
from shader_ray_tpu.app import materials as ref_materials
from shader_ray_tpu.app.driver import App as RefApp
from shader_ray_tpu.config import Config as RefConfig
from shader_ray_tpu.config import use_config
from shader_ray_tpu.engine import Renderer as RefRenderer
from shader_ray_tpu.models import background as ref_background
from shader_ray_tpu.models import obj as ref_obj
from shader_ray_tpu.models import trisrc as ref_trisrc
from shader_ray_tpu.models import world as ref_world
from shader_ray_tpu.models.fixtures import uv_sphere
from shader_ray_tpu.ops.render import RenderStatics as RefStatics
from shader_ray_tpu.ops.render import generate_rays as ref_generate_rays
from shader_ray_tpu.ops.render import trace_rays as ref_trace_rays
from shader_ray_tpu.ops.shading import Rays as RefRays
from shader_ray_tpu.ops.shading import tonemap_and_gamma as ref_tonemap
from shader_ray_tpu.utils import ansi as ref_ansi
from shader_ray_tpu.utils import ppm as ref_ppm
from shader_ray_tpu.utils.hdr import write_hdr
from shader_ray_tpu_torch.app import camera, materials
from shader_ray_tpu_torch.app.driver import App
from shader_ray_tpu_torch.app.main import repl
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.models import background, obj, trisrc, world
from shader_ray_tpu_torch.ops.render import RenderStatics
from shader_ray_tpu_torch.utils import ansi, ppm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOT = os.path.join(ROOT, "tests", "assets", "knot.obj")
SIZE = 32
SCRIPT = ("m", "d", "drag 30 10", "zoom -20", "[", *["."] * 5, *[","] * 5, "set min_contrib 0.004",
          "prog 4", "stats", "s", "q")


def ref_config(**kw) -> RefConfig:
    cfg = RefConfig(**kw)
    cfg.use_native = "never"
    return cfg


def assert_same_sets(got, want):
    for name in ("positions", "normals", "colors", "indices"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def assert_frame_close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.mean() < 2e-3, err.mean()
    assert (err.max(axis=-1) <= 2e-2).mean() >= 0.99, (err.max(axis=-1) > 2e-2).mean()


def test_config_defaults_and_checks_match_the_reference():
    ref, port = RefConfig(), Config()
    for f in dataclasses.fields(Config):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    for bad in (dict(min_contrib=-0.1), dict(env_base=100)):
        with pytest.raises(ValueError):
            Config(**bad).validate()
        with pytest.raises(ValueError):
            RefConfig(**bad).validate()


def test_config_from_env_matches_the_reference(monkeypatch):
    env = {"BVH_MAX_DEPTH": "20", "BVH_LEAF_MAX": "6", "SAH_CTRAV": "1.5",
           "SRT_MAX_LEAF_TESTS": "8", "SAH_CISEC": "3.5", "COLORS_ARE_LINEAR": "1",
           "GEOMETRY_SCALE": "2.5", "SRT_PACKET_KERNEL": "binary", "SRT_ENV_BASE": "512",
           "SRT_ENV_ANISO": "2", "SRT_FUSED": "0", "SRT_MIN_CONTRIB": "0.004",
           "SRT_MAX_STEPS": "100"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref, port = RefConfig.from_env(), Config.from_env()
    for f in dataclasses.fields(Config):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port != Config()  # every variable was read
    assert sum(getattr(port, f.name) != getattr(Config(), f.name) for f in dataclasses.fields(Config)) \
        == len(env)
    monkeypatch.setenv("SRT_MIN_CONTRIB", "-1")
    with pytest.raises(ValueError, match="min_contrib"):
        Config.from_env()


def test_render_statics_from_config_match_the_reference():
    kw = dict(window_width=48, window_height=32, bounce_count=2, cast_shadows=False,
              use_filmic=False, do_tonemap=False, mt_epsilon=1e-6, surface_fudge=2e-4, env_aniso=2)
    port = RenderStatics.from_config(Config(**kw), which=1)
    ref = RefStatics.from_config(RefConfig(**kw), which=1)
    for name in port._fields:
        assert getattr(port, name) == getattr(ref, name), name
    assert RenderStatics.from_config(Config()) == RenderStatics(env_aniso=4)


def test_obj_parser_matches_the_reference():
    with use_config(ref_config()):
        want = ref_obj.parse_obj(KNOT)
    assert_same_sets(obj.parse_obj(KNOT), want)
    text = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1 4//1\nf -4 -3 -2\n"
    assert_same_sets(obj.parse_obj_text(text), ref_obj.parse_obj_text(text))


@pytest.mark.parametrize("knobs", [{}, {"colors_are_linear": True, "geometry_scale": 2.5}])
def test_trisrc_parser_matches_the_reference(tmp_path, knobs):
    pos, nrm = uv_sphere(lat=5, lon=7)
    rng = np.random.default_rng(3)
    col = rng.uniform(0.05, 1.0, size=pos.shape).astype(np.float32)
    path = str(tmp_path / "sphere.trisrc")
    ref_trisrc.write_trisrc(path, pos, nrm, col)
    want = ref_trisrc.parse_trisrc(path, ref_config(**knobs))
    assert_same_sets(trisrc.parse_trisrc(path, Config(**knobs)), want)
    mine = str(tmp_path / "mine.trisrc")
    trisrc.write_trisrc(mine, pos, nrm, col)
    assert open(mine).read() == open(path).read()


def test_load_world_matches_the_reference():
    with use_config(ref_config()):
        want = ref_world.load_world(KNOT, ref_config(), verbose=False)
    got = world.load_world(KNOT, Config(), verbose=False)
    np.testing.assert_array_equal(got.scene_center, want.scene_center)
    assert (got.scene_extent, got.triangle_count) == (want.scene_extent, want.triangle_count)
    np.testing.assert_array_equal(got.bvh.order, want.bvh.order)
    assert world.load_world(KNOT, Config(), verbose=False, build_bvh=False).bvh is None
    with pytest.raises(ValueError, match="extension"):
        world.load_world("scene.ply", Config(), verbose=False)


def test_load_background_matches_the_reference(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.uniform(0.0, 4.0, size=(16, 32, 3)).astype(np.float32)
    write_hdr(str(tmp_path / "sky.hdr"), img)
    ref_ppm.write_ppm(str(tmp_path / "sky.ppm"), img / 4.0)
    np.save(tmp_path / "sky.npy", img)
    specs = ["0.2, 0.3, 0.4", "grid", "33aa77"] + [str(tmp_path / f"sky.{e}") for e in ("hdr", "ppm", "npy")]
    with use_config(ref_config()):
        for spec in specs:
            got, want = background.load_background(spec), ref_background.load_background(spec)
            assert got.dtype == want.dtype and np.array_equal(got, want), spec
    (tmp_path / "sky.png").write_bytes(b"\x89PNG")
    with pytest.raises(ValueError, match=r"\.hdr"):
        background.load_background(str(tmp_path / "sky.png"))
    with pytest.raises(FileNotFoundError):
        background.load_background(str(tmp_path / "none.hdr"))


def test_ppm_and_ansi_match_the_reference(tmp_path):
    rng = np.random.default_rng(9)
    img = rng.uniform(-0.1, 1.1, size=(7, 9, 3)).astype(np.float32)
    ppm.write_ppm(str(tmp_path / "a.ppm"), img)
    ref_ppm.write_ppm(str(tmp_path / "b.ppm"), img)
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()
    np.testing.assert_array_equal(ppm.read_ppm(str(tmp_path / "a.ppm")),
                                  ref_ppm.read_ppm(str(tmp_path / "a.ppm")))
    assert ansi.frame_to_ansi(img, max_cols=5) == ref_ansi.frame_to_ansi(img, max_cols=5)


def test_camera_and_materials_match_the_reference():
    for a, b in ((camera.drag_to_rotation(0.3, -0.2), ref_camera.drag_to_rotation(0.3, -0.2)),
                 (camera.initial_light_rotation(), ref_camera.initial_light_rotation())):
        np.testing.assert_array_equal(a, b)
    rot = np.array([0.4, 0.6, 0.0, 0.8], np.float32)
    np.testing.assert_array_equal(camera.trackball_motion(rot, 0.1, 0.05),
                                  ref_camera.trackball_motion(rot, 0.1, 0.05))
    np.testing.assert_array_equal(camera.update_light(rot), ref_camera.update_light(rot))
    for a, b in zip(camera.create_camera_matrix(np.array([0.0, 0.5, 3.0], np.float32)),
                    ref_camera.create_camera_matrix(np.array([0.0, 0.5, 3.0], np.float32))):
        np.testing.assert_array_equal(a, b)
    centre, pos = np.array([0.1, -0.2, 0.3], np.float32), np.array([0.0, 0.1, 0.0], np.float32)
    for a, b in zip(camera.create_object_matrix(centre, rot, pos),
                    ref_camera.create_object_matrix(centre, rot, pos)):
        np.testing.assert_array_equal(a, b)
    assert camera.initial_zoom(2.6, 0.7) == ref_camera.initial_zoom(2.6, 0.7)
    assert materials.MATERIALS == ref_materials.MATERIALS
    assert materials.DIFFUSE_COLORS == ref_materials.DIFFUSE_COLORS
    for m in range(len(materials.MATERIALS) + 1):
        for d in range(len(materials.DIFFUSE_COLORS) + 1):
            for a, b in zip(materials.resolve_material(m, d), ref_materials.resolve_material(m, d)):
                np.testing.assert_array_equal(a, b)


MATRICES = ("camera_matrix", "camera_normal_matrix", "object_matrix", "object_inverse",
            "object_normal_matrix", "object_normal_inverse")


def assert_same_state(app, ref, after: str):
    for name in MATRICES:
        np.testing.assert_array_equal(getattr(app.world, name), getattr(ref.world, name),
                                      err_msg=f"{name} after {after!r}")
    np.testing.assert_array_equal(app.light_dir, ref.light_dir, err_msg=f"light after {after!r}")
    got = (app.which, app.which_material, app.which_diffuse_color, app.fov, app.zoom,
           app.cfg.min_contrib, app.quit)
    want = (ref.which, ref.which_material, ref.which_diffuse_color, ref.fov, ref.zoom,
            ref.cfg.min_contrib, ref.quit)
    assert got == want, after


def ref_command(ref, line: str) -> None:
    """A REPL line on the reference's App through its methods, without
    rendering (prog, stats and s render only)."""
    cmd, *args = line.split()
    if cmd == "drag":
        ref.drag(float(args[0]), float(args[1]))
    elif cmd == "zoom":
        ref.drag(0.0, float(args[0]), shift=True)
    elif cmd == "set":
        ref.set_knob(args[0], args[1], file=io.StringIO())
    elif cmd not in ("prog", "stats", "s"):
        for ch in cmd:
            ref.key(ch)


def ref_supersample(ref, statics) -> np.ndarray:
    """The reference's which=5 frame of its App's params: its trace_rays
    over the 25 sub-sample rays (fs:654-673), one jitted trace."""
    params = ref.frame_params()
    scene = ref.renderer.scene
    rays, (right, up) = ref_generate_rays(statics, params)
    trace = jax.jit(lambda sc, r: ref_trace_rays(sc, r, params, statics))
    acc = jnp.zeros_like(rays.P)
    for i in range(5):
        for j in range(5):
            D = rays.D + (i / 5 - 0.5) * 0.2 * right + (j / 5 - 0.5) * 0.2 * up
            D = D / jnp.linalg.norm(D, axis=-1, keepdims=True)
            zero = jnp.zeros_like(D)
            acc = acc + trace(scene, RefRays(P=rays.P, D=D, dPdx=zero, dDdx=right - (D @ right)[:, None] * D,
                                             dPdy=zero, dDdy=up - (D @ up)[:, None] * D))
    return np.asarray(ref_tonemap(acc / 25.0, True)).reshape(statics.height, statics.width, 3)


def test_app_repl_matches_the_reference_app(tmp_path, monkeypatch, capsys):
    cfg_ref = ref_config()
    with use_config(cfg_ref):
        ref_w = ref_world.load_world(KNOT, cfg_ref, verbose=False)
        ref_r = RefRenderer(ref_world.get_shader_data(ref_w, cfg_ref),
                            ref_background.load_background("grid"), cfg_ref, engine="wavefront")
        ref = RefApp(ref_w, ref_r, cfg_ref, width=SIZE, height=SIZE)
    cfg = Config()
    w = world.load_world(KNOT, cfg, verbose=False)
    app = App(w, Renderer(world.get_shader_data(w), background.load_background("grid"), cfg,
                          device="cpu"), cfg, width=SIZE, height=SIZE)
    assert_same_state(app, ref, "start")

    def script():
        for line in SCRIPT:
            yield line
            ref_command(ref, line)  # the port's repl has run this line when it asks for the next
            assert_same_state(app, ref, line)

    monkeypatch.chdir(tmp_path)
    repl(app, "frame.ppm", script())
    ref_command(ref, "q")
    assert_same_state(app, ref, "q")
    for name in ("frame.ppm", "color.ppm"):
        assert ppm.read_ppm(str(tmp_path / name)).shape == (SIZE, SIZE, 3)
    err = capsys.readouterr().err
    assert "bounce0: pops/tile" in err and "tris/tile" in err  # three columns a phase
    assert app.cfg.min_contrib == ref.cfg.min_contrib == 0.004

    with use_config(cfg_ref):
        assert (app.which, ref.which) == (0, 0)
        got = app.draw_frame()
        assert got.shape == (SIZE, SIZE, 3) and np.isfinite(got).all() and got.std() > 0.05
        assert_frame_close(got, ref.draw_frame())
        app.which = ref.which = 5
        assert_frame_close(app.draw_frame(), ref_supersample(ref, ref._statics()))


def run_cli(tmp_path, *args, env=None):
    env = {**os.environ, "PYTHONPATH": ROOT, **(env or {})}
    return subprocess.run([sys.executable, "-m", "shader_ray_tpu_torch", *args],
                          capture_output=True, text=True, timeout=120, cwd=tmp_path, env=env)


def test_cli_renders_once_on_the_cpu(tmp_path):
    pos, nrm = uv_sphere(lat=4, lon=6)
    ref_trisrc.write_trisrc(str(tmp_path / "tri.trisrc"), pos, nrm)
    proc = run_cli(tmp_path, "tri.trisrc", "0.2, 0.3, 0.4", "--width", "16", "--height", "16",
                   "--once", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    img = ppm.read_ppm(str(tmp_path / "frame.ppm"))
    assert img.shape == (16, 16, 3) and img.std() > 0


def test_cli_refuses_the_cpu_unless_asked(tmp_path):
    proc = run_cli(tmp_path, KNOT, "grid", "--once", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert not (tmp_path / "frame.ppm").exists()
