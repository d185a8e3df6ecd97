"""Browser live viewer (counterpart of shader_ray_tpu/app/webview.py):
the interactive window of a headless host, in place of the reference's
GLFW display (ray.cpp:964-984).

``python -m shader_ray_tpu_torch model bg --serve PORT`` serves one page
that shows the current frame and feeds mouse and keyboard events into the
App's interaction state machine (app/driver.py), the one the stdin REPL
drives: drags rotate the object or light (MotionCallback,
ray.cpp:862-918), shift-drag zooms (ray.cpp:902), keys follow the
reference key map (ray.cpp:791-856).  Rendering is damage-driven like the
reference's ``redraw_window`` loop (ray.cpp:1132-1142) and runs on the
thread that owns the card, in ``step()`` and ``run()``.  HTTP handler
threads only change interaction state under the lock (``App.key``,
``button``, ``motion`` are host-only) and read the last encoded frame;
no CUDA call runs on them.  A screenshot key, which may render, waits
for the next ``step()`` as the benchmark key does.

Transport: GET ``/state`` is polled for a frame serial, GET
``/frame.png`` fetches the current frame (utils/png.py), POST ``/event``
delivers input.  No websockets, no external packages.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from shader_ray_tpu_torch.utils.png import encode_png

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>shader-ray-tpu (PyTorch/CUDA)</title><style>
 body{background:#14141a;color:#cfcfe0;font:13px monospace;margin:16px}
 #v{image-rendering:pixelated;border:1px solid #333;cursor:crosshair;
    display:block;margin-top:8px;user-select:none;-webkit-user-drag:none}
 #s{white-space:pre}
 kbd{background:#26262e;border-radius:3px;padding:0 4px}
</style></head><body>
<div id="s">connecting…</div>
<img id="v" draggable="false" alt="frame">
<div>drag: rotate (<kbd>o</kbd> object / <kbd>l</kbd> light) ·
 shift-drag: zoom · <kbd>m</kbd> material · <kbd>d</kbd> diffuse ·
 <kbd>,</kbd>/<kbd>.</kbd> which · <kbd>[</kbd>/<kbd>]</kbd> fov ·
 <kbd>s</kbd> screenshot · <kbd>b</kbd> benchmark · <kbd>q</kbd> quit</div>
<script>
const v=document.getElementById('v'),s=document.getElementById('s');
let serial=-1,stopped=false;
async function post(ev){try{await fetch('/event',{method:'POST',
  body:JSON.stringify(ev)});}catch(e){}}
async function poll(){
  if(stopped)return;
  try{
    const st=await (await fetch('/state')).json();
    s.textContent=`which=${st.which} material=${st.material} `+
      `diffuse=${st.diffuse} fov=${st.fov_degrees.toFixed(1)}° `+
      `${st.width}x${st.height} frame #${st.serial}`;
    if(st.serial!==serial){serial=st.serial;v.src='/frame.png?s='+serial;}
    if(st.quit){stopped=true;s.textContent+='  [quit]';return;}
  }catch(e){s.textContent='disconnected';stopped=true;return;}
  setTimeout(poll,100);}
poll();
let down=false;
v.addEventListener('mousedown',e=>{down=true;
  post({type:'button',pressed:true,x:e.offsetX,y:e.offsetY,
        shift:e.shiftKey});e.preventDefault();});
window.addEventListener('mouseup',e=>{if(down){down=false;
  post({type:'button',pressed:false,x:0,y:0});}});
v.addEventListener('mousemove',e=>{if(down)
  post({type:'motion',x:e.offsetX,y:e.offsetY});});
window.addEventListener('keydown',e=>{
  if(e.key.length===1&&!e.ctrlKey&&!e.metaKey){post({type:'key',k:e.key});
    e.preventDefault();}
  else if(e.key==='Escape')post({type:'key',k:'\\u001b'});});
</script></body></html>"""


class WebViewer:
    """Serves the App over HTTP.  ``start()`` spins the server thread;
    ``step()`` (call from the owning thread) renders when dirty and
    re-encodes the frame; ``run()`` is the blocking damage-driven
    loop used by ``--serve``."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 8765):
        self.app = app
        self.lock = threading.Lock()
        self.serial = 0
        self._png: bytes | None = None
        self._screenshot = False  # a screenshot key waiting for step()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet access log
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html; charset=utf-8",
                               PAGE.encode())
                elif path == "/state":
                    self._send(200, "application/json",
                               json.dumps(viewer.state()).encode())
                elif path == "/frame.png":
                    png = viewer._png
                    if png is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.split("?")[0] != "/event":
                    self._send(404, "text/plain", b"not found")
                    return
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                    viewer.handle_event(ev)
                    self._send(200, "application/json", b'{"ok":true}')
                except Exception as e:  # a bad event must not kill the app
                    self._send(400, "text/plain", str(e).encode())

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.server.daemon_threads = True
        self.host, self.port = self.server.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def state(self) -> dict:
        from shader_ray_tpu_torch.app.materials import DIFFUSE_COLORS, MATERIALS

        app = self.app
        return {
            "serial": self.serial,
            "which": app.which,
            "material": MATERIALS[app.which_material % len(MATERIALS)].name,
            "diffuse": list(
                DIFFUSE_COLORS[app.which_diffuse_color % len(DIFFUSE_COLORS)]
            ),
            "fov_degrees": float(np.rad2deg(app.fov)),
            "width": app.width,
            "height": app.height,
            "quit": app.quit,
        }

    def handle_event(self, ev: dict) -> None:
        """Input events from handler threads: mutate interaction state
        only (host math); all device work stays in step()."""
        t = ev.get("type")
        with self.lock:
            if t == "key" and str(ev["k"])[:1] in ("s", "S"):
                self._screenshot = True  # App.screenshot may render
            elif t == "key":
                self.app.key(str(ev["k"])[:1])
            elif t == "button":
                self.app.button(
                    bool(ev["pressed"]), float(ev.get("x", 0)),
                    float(ev.get("y", 0)), bool(ev.get("shift", False)),
                )
            elif t == "motion":
                self.app.motion(float(ev["x"]), float(ev["y"]))
            else:
                raise ValueError(f"unknown event type {t!r}")

    def start(self) -> str:
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self._thread.start()
        return self.url

    def step(self) -> bool:
        """Render-if-dirty + encode; returns True when a new frame was
        produced.  Runs the deferred benchmark like the REPL, and the
        deferred screenshot."""
        with self.lock:
            if self.app.do_benchmark:
                self.app.do_benchmark = False
                self.app.benchmark(file=sys.stderr)
            frame = self.app.render()
            if self._screenshot:
                self._screenshot = False
                self.app.screenshot("color.ppm")
            if frame is None:
                if self._png is None and self.app._frame is not None:
                    # app was clean when serving started (the REPL
                    # renders before the command loop): seed from the
                    # existing frame so /frame.png never 404s
                    frame = self.app._frame
                else:
                    return False
            self._png = encode_png(frame)
            self.serial += 1
            return True

    def run(self, poll: float = 0.03) -> None:
        """Blocking damage-driven loop (reference ray.cpp:1132-1142's
        glfwWaitEvents analog, with HTTP events as the wake source)."""
        try:
            while not self.app.quit:
                if not self.step():
                    time.sleep(poll)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self, *, timeout: float = 10.0) -> None:
        """Stop serving and join the server thread (within ``timeout``)."""
        if self._thread is not None:
            self.server.shutdown()
            self._thread.join(timeout)
            self._thread = None
        self.server.server_close()
