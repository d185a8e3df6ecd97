"""The port's browser viewer (app/webview.py) on the CPU: its HTTP surface
(``/``, ``/state``, ``/frame.png``, ``POST /event``) over an App with
``device="cpu"`` at 32 x 48, the served PNG equal to the App's frame as
``ppm.write_ppm`` quantizes it, events driving the App's state machine
exactly as the same calls made directly do, the deferred screenshot, the
damage-driven ``run()`` loop ended by ``q``, and the CLI's ``--serve`` and
the REPL's ``serve`` with the reference's precedence.  Every server binds
127.0.0.1 port 0, every join has a timeout and every server stops in a
``finally``."""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from shader_ray_tpu_torch.app import main as app_main
from shader_ray_tpu_torch.app import webview
from shader_ray_tpu_torch.app.driver import App
from shader_ray_tpu_torch.app.webview import WebViewer
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.models.fixtures import procedural_sky, uv_sphere
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.utils.png import decode_png
from shader_ray_tpu_torch.utils.ppm import read_ppm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 48, 32
JOIN = 60.0  # seconds any thread of a test may take to end


@pytest.fixture(scope="module")
def renderer():
    pos, nrm = uv_sphere(lat=6, lon=8)
    world = make_world(TriangleSet.from_arrays(pos, nrm))
    return world, Renderer(get_shader_data(world), procedural_sky(32), device="cpu")


def _app(renderer) -> App:
    world, r = renderer
    # a World of its own: the App writes its view matrices into it
    twin = make_world(world.triangles, build_bvh=False)
    return App(twin, r, width=W, height=H)


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _post(url: str, payload: dict) -> bytes:
    req = urllib.request.Request(url + "event", data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def _quantized(frame: np.ndarray) -> np.ndarray:
    return (np.clip(frame, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def test_http_surface(renderer):
    app = _app(renderer)
    viewer = WebViewer(app, port=0)
    url = viewer.start()
    try:
        assert url.startswith("http://127.0.0.1:") and b"shader-ray-tpu" in _get(url)
        st = json.loads(_get(url + "state"))
        assert st == {"serial": 0, "which": 0, "material": "gold", "diffuse": [1.0, 1.0, 1.0],
                      "fov_degrees": pytest.approx(40.0), "width": W, "height": H, "quit": False}
        for path in ("frame.png", "nowhere"):  # no frame before the first step
            with pytest.raises(urllib.error.HTTPError, match="404"):
                _get(url + path)
        assert viewer.step()  # the App starts dirty
        frame = decode_png(_get(url + "frame.png?s=1"))
        assert frame.shape == (H, W, 3) and frame.max() > 40
        np.testing.assert_array_equal(frame, _quantized(app._frame))
        assert not viewer.step()  # clean: no new frame
        assert json.loads(_get(url + "state"))["serial"] == 1
        with pytest.raises(urllib.error.HTTPError, match="400"):
            _post(url, {"type": "bogus"})
        req = urllib.request.Request(url + "elsewhere", data=b"{}", method="POST")
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(req, timeout=10)
        assert b"shader-ray-tpu" in _get(url)  # still serving
    finally:
        viewer.stop()


def test_events_drive_the_app_as_direct_calls(renderer):
    """Keys, a drag and a shift-drag over HTTP leave the App in the state
    the same calls made directly leave a twin App in; the next step
    serves the twin's frame."""
    app, twin = _app(renderer), _app(renderer)
    viewer = WebViewer(app, port=0)
    url = viewer.start()
    events = [
        {"type": "key", "k": "."}, {"type": "key", "k": "."}, {"type": "key", "k": ","},
        {"type": "key", "k": "m"}, {"type": "key", "k": "d"}, {"type": "key", "k": "["},
        {"type": "key", "k": "l"},
        {"type": "button", "pressed": True, "x": 4, "y": 16},
        {"type": "motion", "x": 8, "y": 16}, {"type": "motion", "x": 40, "y": 25},
        {"type": "button", "pressed": False, "x": 0, "y": 0},
        {"type": "key", "k": "o"},
        {"type": "button", "pressed": True, "x": 24, "y": 16, "shift": True},
        {"type": "motion", "x": 24, "y": 4},
        {"type": "button", "pressed": False},
    ]
    try:
        assert viewer.step()
        for ev in events:
            _post(url, ev)
            if ev["type"] == "key":
                twin.key(ev["k"])
            elif ev["type"] == "button":
                twin.button(ev["pressed"], ev.get("x", 0), ev.get("y", 0), ev.get("shift", False))
            else:
                twin.motion(ev["x"], ev["y"])
        for name in ("camera_matrix", "object_matrix", "object_normal_matrix"):
            np.testing.assert_array_equal(getattr(app.world, name), getattr(twin.world, name))
        np.testing.assert_array_equal(app.light_dir, twin.light_dir)
        assert (app.which, app.which_material, app.which_diffuse_color, app.fov, app.zoom) == \
            (twin.which, twin.which_material, twin.which_diffuse_color, twin.fov, twin.zoom)
        st = json.loads(_get(url + "state"))
        assert (st["which"], st["material"], st["diffuse"]) == (1, "silver", [1.0, 0.5, 0.5])
        assert app.redraw and viewer.step()
        frame = decode_png(_get(url + "frame.png"))
        np.testing.assert_array_equal(frame, _quantized(twin.draw_frame()))
    finally:
        viewer.stop()


def test_screenshot_key_waits_for_the_owning_thread(renderer, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    app = _app(renderer)
    viewer = WebViewer(app, port=0)
    url = viewer.start()
    try:
        _post(url, {"type": "key", "k": "s"})
        assert not (tmp_path / "color.ppm").exists()  # nothing rendered on the handler thread
        assert app._frame is None
        assert viewer.step()
        np.testing.assert_array_equal(read_ppm(str(tmp_path / "color.ppm")), _quantized(app._frame))
    finally:
        viewer.stop()


def test_seeds_from_an_existing_frame(renderer):
    app = _app(renderer)
    app.render()  # clean, with a frame, as after the REPL's first render
    viewer = WebViewer(app, port=0)
    url = viewer.start()
    try:
        assert viewer.step()
        np.testing.assert_array_equal(decode_png(_get(url + "frame.png")), _quantized(app._frame))
        assert not viewer.step()
    finally:
        viewer.stop()


def _wait_serial(url: str, above: int, deadline: float) -> dict:
    while True:
        st = json.loads(_get(url + "state"))
        if st["serial"] > above or time.time() > deadline:
            return st
        time.sleep(0.02)


def test_run_loop_renders_on_its_thread_and_ends_on_q(renderer):
    app = _app(renderer)
    viewer = WebViewer(app, port=0)
    url = viewer.start()
    runner = threading.Thread(target=viewer.run, kwargs={"poll": 0.01}, daemon=True)
    runner.start()
    try:
        deadline = time.time() + JOIN
        st = _wait_serial(url, 0, deadline)
        assert st["serial"] >= 1, "run() produced no first frame"
        png0 = _get(url + "frame.png")
        for ev in ({"type": "button", "pressed": True, "x": 4, "y": 16},
                   {"type": "motion", "x": 8, "y": 16}, {"type": "motion", "x": 44, "y": 30},
                   {"type": "button", "pressed": False}):
            _post(url, ev)
        # the loop may render mid-drag (the press marks the frame dirty):
        # wait for a frame that shows the rotation
        png1 = png0
        while png1 == png0 and time.time() < deadline:
            st = _wait_serial(url, st["serial"], deadline)
            png1 = _get(url + "frame.png")
        assert st["serial"] >= 2 and png1 != png0, "the drag did not redraw"
        _post(url, {"type": "key", "k": "q"})
        runner.join(JOIN)
        assert not runner.is_alive(), "run() did not return after q"
        with pytest.raises(urllib.error.URLError):  # stopped serving
            _get(url + "state")
    finally:
        app.quit = True  # whatever failed, run() must return
        runner.join(JOIN)
        viewer.stop()


def test_cli_serve_and_repl_serve_follow_the_references_precedence(renderer, tmp_path,
                                                                  monkeypatch):
    """``--once`` wins over ``--serve``; ``--serve PORT`` serves instead of
    the REPL; the REPL's ``serve [PORT]`` serves (default 8765) and ends
    the REPL if the page quit.  Then ``serve`` for real on port 0, quit
    from a client thread."""
    monkeypatch.chdir(tmp_path)
    app = _app(renderer)
    monkeypatch.setattr(app_main, "build_app", lambda args: app)
    calls = []

    def fake_serve(a, port):
        calls.append(port)
        a.quit = port == 7

    monkeypatch.setattr(app_main, "serve", fake_serve)
    assert app_main.main(["m.obj", "grid", "--once", "--serve", "5"]) == 0
    assert calls == [] and (tmp_path / "frame.ppm").exists()
    assert app_main.main(["m.obj", "grid", "--serve", "5"]) == 0
    assert calls == [5]
    app_main.repl(app, str(tmp_path / "f.ppm"), io.StringIO("serve\nserve 7\nm\n"))
    assert calls == [5, 8765, 7] and app.which_material == 0  # "m" never ran
    monkeypatch.undo()

    urls = []
    start = WebViewer.start

    def recorded_start(self):
        urls.append(start(self))
        return urls[-1]

    monkeypatch.setattr(webview.WebViewer, "start", recorded_start)
    app = _app(renderer)

    posted = []

    def client():
        try:
            deadline = time.time() + JOIN
            while not urls and time.time() < deadline:
                time.sleep(0.01)
            _wait_serial(urls[0], 0, deadline)
            _post(urls[0], {"type": "key", "k": "q"})
            posted.append(True)
        finally:
            app.quit = True  # whatever failed, serve() must return

    t = threading.Thread(target=client, daemon=True)
    t.start()
    try:
        app_main.serve(app, 0)
    finally:
        t.join(JOIN)
    assert posted and not t.is_alive() and app._frame is not None
    assert os.path.basename(urls[0]) == "" and urls[0].startswith("http://127.0.0.1:")
