"""Background / environment image loading (counterpart of
shader_ray_tpu/models/background.py; reference ray.cpp:330-344,
1002-1075).  ``load_background`` accepts

* ``"r, g, b"`` floats -> 1x1 constant image (ray.cpp:1004-1008);
* ``grid``             -> procedural 2048x1024 white-on-black grid,
                          8-px tiles (ray.cpp:1009-1029);
* ``rrggbb`` hex       -> 1x1 constant (ray.cpp:1030-1034);
* a file path: Radiance ``.hdr`` (RGBE, ``read_hdr``); the LDR images
  PNG (``utils.png.decode_png``), BMP/DIB (``models.ldr.read_bmp``),
  TGA (``read_tga``), baseline JPEG (``utils.jpeg.read_jpeg``) and binary
  PPM ``.ppm`` / ``.pnm``, each as float/255 with no gamma linearization
  (the reference's LDR path, ray.cpp:1056-1067); or a numpy ``.npy``
  array.

The reference falls back to PIL for what its readers refuse; this
package does not: an unsupported variant (16-bit PNG, progressive JPEG,
compressed BMP...) raises ``ValueError`` with the reader's message.
"""

from __future__ import annotations

import os
import re

import numpy as np

from shader_ray_tpu_torch import native
from shader_ray_tpu_torch.config import Config

_FLOAT_SPEC = re.compile(
    r"^\s*([-+0-9.eE]+)\s*,\s*([-+0-9.eE]+)\s*,\s*([-+0-9.eE]+)\s*$"
)
_HEX_SPEC = re.compile(r"^([0-9a-fA-F]{2})([0-9a-fA-F]{2})([0-9a-fA-F]{2})$")
FORMATS = ".hdr, .png, .bmp, .dib, .tga, .icb, .vda, .vst, .jpg, .jpeg, .jfif, .ppm, .pnm, .npy"


def constant_image(r: float, g: float, b: float) -> np.ndarray:
    return np.array([[[r, g, b]]], dtype=np.float32)


def grid_image(width: int = 2048, tilesize: int = 8, barsize: int = 1) -> np.ndarray:
    """Procedural white-on-black grid (ray.cpp:1009-1029)."""
    height = width // 2
    i = np.arange(width)[None, :]
    j = np.arange(height)[:, None]
    grid = ((i % tilesize) < barsize) | ((j % tilesize) < barsize)
    img = np.zeros((height, width, 3), dtype=np.float32)
    img[grid] = 1.0
    return img


def read_hdr(path: str, config: Config | None = None) -> np.ndarray:
    """Radiance RGBE (.hdr) reader -> (H, W, 3) float32, scanline 0 first.

    Supports the common -Y H +X W orientation with both RLE and flat
    scanlines.  (The reference delegated to FreeImagePlus FIT_RGBF,
    ray.cpp:1048-1054.)  Reads through the native reader where
    ``Config.use_native`` lets it (native.py).
    """
    if native.wanted((config or Config()).use_native):
        return native.read_hdr_file(path)
    with open(path, "rb") as f:
        data = f.read()

    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = 0
    while True:  # header lines up to the empty one
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res = data[pos:nl].decode("ascii").split()
    pos = nl + 1
    if len(res) != 4 or res[0] != "-Y" or res[2] != "+X":
        raise ValueError(f"{path}: unsupported HDR orientation {' '.join(res)}")
    height = int(res[1])
    width = int(res[3])

    rgbe = np.zeros((height, width, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    p = pos
    for y in range(height):
        if (
            8 <= width < 32768
            and p + 4 <= len(buf)
            and buf[p] == 2
            and buf[p + 1] == 2
            and ((int(buf[p + 2]) << 8) | int(buf[p + 3])) == width
        ):
            # adaptive RLE scanline: 4 component planes
            p += 4
            for c in range(4):
                x = 0
                while x < width:
                    code = int(buf[p])
                    p += 1
                    if code > 128:  # run
                        run = code - 128
                        rgbe[y, x : x + run, c] = buf[p]
                        p += 1
                        x += run
                    else:  # literal
                        rgbe[y, x : x + code, c] = buf[p : p + code]
                        p += code
                        x += code
        else:
            flat = buf[p : p + width * 4].reshape(width, 4)
            rgbe[y] = flat
            p += width * 4

    mant = rgbe[..., :3].astype(np.float32)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(1.0, exp - 136).astype(np.float32)  # 2^(e-128-8)
    img = mant * scale[..., None]
    img[exp == 0] = 0.0
    return img.astype(np.float32)


def load_background(spec: str, config: Config | None = None) -> np.ndarray:
    """Parse a background spec into an (H, W, 3) float32 lat-long image,
    row 0 the top scanline (module docstring); ``config.use_native``
    picks the .hdr reader (``read_hdr``)."""
    m = _FLOAT_SPEC.match(spec)
    if m:
        return constant_image(float(m.group(1)), float(m.group(2)), float(m.group(3)))
    if spec == "grid":
        return grid_image()
    m = _HEX_SPEC.match(spec)
    if m:
        return constant_image(
            int(m.group(1), 16) / 255.0,
            int(m.group(2), 16) / 255.0,
            int(m.group(3), 16) / 255.0,
        )
    if not os.path.exists(spec):
        raise FileNotFoundError(f"Failed to load image from {spec}")
    ext = spec.rsplit(".", 1)[-1].lower()
    if ext == "hdr":
        return read_hdr(spec, config)
    if ext in ("ppm", "pnm"):
        from shader_ray_tpu_torch.utils.ppm import read_ppm

        return read_ppm(spec).astype(np.float32) / 255.0
    if ext == "npy":
        return np.load(spec).astype(np.float32)
    if ext == "png":
        from shader_ray_tpu_torch.utils.png import decode_png

        with open(spec, "rb") as f:
            return decode_png(f.read()).astype(np.float32) / 255.0
    if ext in ("bmp", "dib"):
        from shader_ray_tpu_torch.models.ldr import read_bmp

        return read_bmp(spec).astype(np.float32) / 255.0
    if ext in ("tga", "icb", "vda", "vst"):
        from shader_ray_tpu_torch.models.ldr import read_tga

        return read_tga(spec).astype(np.float32) / 255.0
    if ext in ("jpg", "jpeg", "jfif"):
        from shader_ray_tpu_torch.utils.jpeg import read_jpeg

        return read_jpeg(spec).astype(np.float32) / 255.0
    raise ValueError(f"Unhandled image type for {spec}: this package reads {FORMATS}")
