"""``python -m shader_ray_tpu_torch model background``: the CLI and REPL
(app/main.py)."""

from shader_ray_tpu_torch.app.main import main

if __name__ == "__main__":
    raise SystemExit(main())
