"""CLI entry: ``python -m shader_ray_tpu_torch model background``
(counterpart of shader_ray_tpu/app/main.py).

The reference's positional interface (usage ray.cpp:945-950): a model
file (.trisrc / .obj) and a background spec ("r, g, b" floats, ``grid``,
hex ``rrggbb``, or an image path: .hdr, .ppm/.pnm, .npy).  The reference
opens a GLFW window; here a stdin REPL takes the same key bindings
(ray.cpp:791-856) plus drag/zoom commands and writes frames to PPM.

It renders on the CUDA card; ``--device cpu`` runs the kernels' plain
PyTorch versions instead.  Without a card and without ``--device cpu``
it exits non-zero with the Renderer's message.
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
  help         this text
"""


def build_app(args):
    """Scene, background, Renderer and App from the parsed arguments,
    with ``Config.from_env()``.  Checks for the card before loading."""
    from shader_ray_tpu_torch.app.driver import App
    from shader_ray_tpu_torch.config import Config
    from shader_ray_tpu_torch.engine import Renderer, pick_device
    from shader_ray_tpu_torch.models.background import load_background
    from shader_ray_tpu_torch.models.world import get_shader_data, load_world

    device = pick_device(None if args.device == "cuda" else args.device)
    cfg = Config.from_env()
    world = load_world(args.model, cfg)
    data = get_shader_data(world)
    background = load_background(args.background)
    renderer = Renderer(data, background, cfg, device=device)
    print(f"device: {renderer.device}", file=sys.stderr)
    return App(world, renderer, cfg, width=args.width, height=args.height)


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
        elif cmd in ("tune", "serve"):
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="shader_ray_tpu_torch",
        description="interactive ray tracer on an NVIDIA GPU (PyTorch/CUDA)",
    )
    p.add_argument("model", help="scene file (.trisrc or .obj)")
    p.add_argument("background", help='env spec: "r, g, b" | grid | rrggbb hex | .hdr/.ppm/.npy path')
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--devices", type=int, default=1,
                   help="devices to shard the frame over (only 1 in this package)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the card (the default); cpu: the kernels' plain PyTorch versions")
    p.add_argument("--out", default="frame.ppm", help="output frame path")
    p.add_argument("--once", action="store_true", help="render one frame and exit (no REPL)")
    p.add_argument("--view", action="store_true",
                   help="display each frame inline as ANSI truecolor")
    args = p.parse_args(argv)
    if args.devices != 1:
        p.error(f"--devices {args.devices}: this package renders on one device")

    try:
        app = build_app(args)
    except RuntimeError as e:  # no card, and the CPU was not asked for
        print(f"shader_ray_tpu_torch: {e}", file=sys.stderr)
        return 1
    except (FileNotFoundError, ValueError) as e:
        # fail fast with a message, like the reference (ray.cpp:996-999)
        print(f"Couldn't load scene: {e}", file=sys.stderr)
        return 1
    if args.once:
        _emit(app.render(), args.out, args.view)
        return 0
    repl(app, args.out, sys.stdin, view=args.view)
    return 0


if __name__ == "__main__":
    sys.exit(main())
