"""CLI entry: ``python -m shader_ray_tpu_torch model background``
(counterpart of shader_ray_tpu/app/main.py).

The reference's positional interface (usage ray.cpp:945-950): a model
file (.trisrc / .obj) and a background spec ("r, g, b" floats, ``grid``,
hex ``rrggbb``, or an image path: .hdr, .png, .bmp, .tga, .jpg,
.ppm/.pnm, .npy).  The reference opens a GLFW window; here a stdin REPL
takes the same key bindings (ray.cpp:791-856) plus drag/zoom commands
and writes frames to PPM, and ``--serve PORT`` (or the REPL's ``serve``)
shows the frames in a browser and takes its mouse and keys
(app/webview.py).  The built scene is cached by content and build knobs
(utils/cache.py; ``Config.scene_cache``, SRT_CACHE_DIR).

It renders on the CUDA card; ``--device cpu`` runs the kernels' plain
PyTorch versions instead.  Without a card and without ``--device cpu``
it exits non-zero with the Renderer's message.  ``--devices N`` shards
each frame over the first N cards (0: all; parallel/mesh.py), one
process driving them all, as the reference's CLI does; asked for more
cards than the machine has, it exits non-zero naming both numbers.  With
``--device cpu``, N > 1 makes N CPU shards.
"""

from __future__ import annotations

import argparse
import sys

HELP = """\
commands (reference key map, ray.cpp:791-856):
  [ / ]        fov divide/multiply by 1.05
  , / .        debug mode `which` -/+
  o / l        mouse target: object / light
  m            cycle material (gold silver copper iron alum plastic...)
  d            cycle diffuse color (white reddish green blueish)
  b            benchmark: 100 frames, duration histogram
  s            screenshot -> color.ppm
  p            print the camera and object matrices and the light
  q            quit
extra (headless equivalents of mouse gestures):
  drag DX DY   trackball-rotate current target by a pixel drag
  zoom DY      shift-drag zoom by DY pixels (negative = zoom in)
  render [F]   force a frame; optionally write it to file F (.ppm)
  prog [N]     progressive render: average N jittered samples (default 4)
  stats        per-phase walk counters (node pops, leaf visits, triangle
               tests per 16x16 tile)
  set K V      set a config knob live (e.g. `set min_contrib 0.004`);
               `set` alone lists knobs
  view         toggle inline ANSI-truecolor display of each frame
  serve [PORT] browser live viewer: serve frames + take mouse/keyboard
               input over HTTP until quit (also --serve PORT)
  help         this text
"""


def build_app(args):
    """Scene, background, Renderer and App from the parsed arguments,
    with ``Config.from_env()``.  Checks for the card before loading.  On
    a scene-cache hit the BVH is not built: the World then serves only
    the centre, extent and view matrices."""
    from shader_ray_tpu_torch.app.driver import App
    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.engine import Renderer, pick_device
    from shader_ray_tpu_torch.models.background import load_background
    from shader_ray_tpu_torch.models.world import get_shader_data, load_world, scene_fingerprint
    from shader_ray_tpu_torch.utils.cache import load_scene_data, save_scene_data

    device = pick_device(None if args.device == "cuda" else args.device)
    mesh = cli_mesh(args.devices, device)
    cfg = Config.from_env()
    key = scene_fingerprint(args.model, cfg) if cfg.scene_cache else None
    data = load_scene_data(key) if key is not None else None
    if data is not None:
        print(f"scene cache hit: {key}", file=sys.stderr)
        world = load_world(args.model, cfg, build_bvh=False)
    else:
        world = load_world(args.model, cfg)
        data = get_shader_data(world, cfg, verbose=True)
        if key is not None:
            try:
                save_scene_data(key, data)
            except OSError:  # a read-only cache directory costs only the cache
                pass
    background = load_background(args.background, config=cfg)
    renderer = Renderer(data, background, cfg, device=device, mesh=mesh)
    print(f"device: {renderer.device}" + (f", mesh of {len(mesh)}: {', '.join(map(str, mesh))}"
                                          if mesh else ""), file=sys.stderr)
    return App(world, renderer, cfg, width=args.width, height=args.height)


def cli_mesh(devices: int, device):
    """The mesh of ``--devices N`` on ``device``: None for one device; on
    the card the first N CUDA devices (0: all), raising RuntimeError when
    the machine has fewer; on the CPU N shards of it."""
    if devices < 0:
        raise RuntimeError(f"--devices {devices}: need 0 (all) or more")
    if device.type == "cpu":
        return ["cpu"] * devices if devices > 1 else None
    from shader_ray_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices)
    return mesh if len(mesh) > 1 else None


def _emit(frame, path: str, view: bool) -> None:
    from shader_ray_tpu_torch.utils.ppm import write_ppm

    write_ppm(path, frame)
    print(f"wrote {path}", file=sys.stderr)
    if view:
        from shader_ray_tpu_torch.utils.ansi import print_frame

        print_frame(frame)


def repl(app, out_path: str, stream, view: bool = False) -> None:
    """Read commands from ``stream`` (HELP) until ``q`` or its end,
    writing each new frame to ``out_path``."""
    frame = app.render()
    if frame is not None:
        _emit(frame, out_path, view)

    for line in stream:
        parts = line.split()
        if not parts:
            continue
        cmd = parts[0]
        if cmd == "help":
            print(HELP, end="")
        elif cmd == "view":
            view = not view
            print(f"view = {view}", file=sys.stderr)
            if view and app._frame is not None:
                from shader_ray_tpu_torch.utils.ansi import print_frame

                print_frame(app._frame)
            continue
        elif cmd == "drag" and len(parts) == 3:
            app.drag(float(parts[1]), float(parts[2]))
        elif cmd == "zoom" and len(parts) == 2:
            app.drag(0.0, float(parts[1]), shift=True)
        elif cmd == "stats":
            app.walk_stats(file=sys.stderr)
        elif cmd == "serve":
            serve(app, int(parts[1]) if len(parts) > 1 else 8765)
            if app.quit:
                break
            continue
        elif cmd == "tune":
            print(f"{cmd}: not in this package yet", file=sys.stderr)
            continue
        elif cmd == "set":
            if len(parts) == 3:
                app.set_knob(parts[1], parts[2], file=sys.stderr)
            elif len(parts) == 2:
                print(f"usage: set {parts[1].upper()} VALUE", file=sys.stderr)
            else:
                app.set_knob("", "", file=sys.stderr)  # bare set: list the knobs
            continue
        elif cmd == "prog":
            n = int(parts[1]) if len(parts) > 1 else 4
            _emit(app.render_progressive(n), out_path, view)
            print(f"({n} samples)", file=sys.stderr)
            continue
        elif cmd == "render":
            app.redraw = True
            _emit(app.render(), parts[1] if len(parts) > 1 else out_path, view)
            continue
        else:
            for ch in cmd:
                app.key(ch)
        if app.do_benchmark:
            app.do_benchmark = False
            app.benchmark()
        if app.quit:
            break
        frame = app.render()
        if frame is not None:
            _emit(frame, out_path, view)


def serve(app, port: int) -> None:
    """Run the browser live viewer (app/webview.py) on this thread until
    the user quits from the page (or Ctrl-C)."""
    from shader_ray_tpu_torch.app.webview import WebViewer

    viewer = WebViewer(app, port=port)
    print(f"live viewer at {viewer.start()}  (q in the page quits)", file=sys.stderr)
    viewer.run()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="shader_ray_tpu_torch",
        description="interactive ray tracer on an NVIDIA GPU (PyTorch/CUDA)",
    )
    p.add_argument("model", help="scene file (.trisrc or .obj)")
    p.add_argument("background", help='env spec: "r, g, b" | grid | rrggbb hex | image path '
                   "(.hdr/.png/.bmp/.tga/.jpg/.ppm/.npy)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--devices", type=int, default=1,
                   help="cards to shard each frame over (0 = all); with --device cpu, CPU shards")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the card (the default); cpu: the kernels' plain PyTorch versions")
    p.add_argument("--out", default="frame.ppm", help="output frame path")
    p.add_argument("--once", action="store_true", help="render one frame and exit (no REPL)")
    p.add_argument("--view", action="store_true",
                   help="display each frame inline as ANSI truecolor")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="browser live viewer: serve frames over HTTP on PORT and take "
                   "mouse/keyboard input from the page")
    args = p.parse_args(argv)

    try:
        app = build_app(args)
    except RuntimeError as e:  # no card (or fewer than --devices), and the CPU was not asked for
        print(f"shader_ray_tpu_torch: {e}", file=sys.stderr)
        return 1
    except (FileNotFoundError, ValueError) as e:
        # fail fast with a message, like the reference (ray.cpp:996-999)
        print(f"Couldn't load scene: {e}", file=sys.stderr)
        return 1
    if args.once:
        _emit(app.render(), args.out, args.view)
        return 0
    if args.serve is not None:
        serve(app, args.serve)
        return 0
    repl(app, args.out, sys.stdin, view=args.view)
    return 0


if __name__ == "__main__":
    sys.exit(main())
