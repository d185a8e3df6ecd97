"""Binary PPM (P6) read/write.

The reference screenshot path writes the GL front buffer as P6 with
rows flipped bottom-up (ray.cpp:730-787).  Our framebuffers are
already top-down (row 0 = top scanline), so ``write_ppm`` writes rows
in order; the on-disk result matches the reference's ``color.ppm``
orientation.
"""

from __future__ import annotations

import numpy as np


def write_ppm(path: str, image: np.ndarray) -> None:
    """image: (H, W, 3) float [0,1] or uint8, row 0 = top."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6 {w} {h} 255\n".encode("ascii"))
        f.write(img[..., :3].tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read binary P6 -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    # header: P6 <w> <h> <maxval> then single whitespace then raster
    tokens: list[bytes] = []
    pos = 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            nl = data.index(b"\n", pos)
            pos = nl + 1
            continue
        end = pos
        while end < len(data) and not data[end : end + 1].isspace():
            end += 1
        tokens.append(data[pos:end])
        pos = end
    pos += 1  # single whitespace after maxval
    if tokens[0] != b"P6":
        raise ValueError(f"{path}: not a P6 PPM")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"{path}: unsupported maxval {maxval}")
    raster = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=pos)
    return raster.reshape(h, w, 3).copy()
