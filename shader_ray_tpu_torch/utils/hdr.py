"""Radiance RGBE (.hdr) writer (counterpart of shader_ray_tpu/utils/hdr.py;
the reader is models.background.read_hdr).  Writes adaptive-RLE
scanlines in the common -Y H +X W orientation, flat scanlines where the
width is outside [8, 32768)."""

from __future__ import annotations

import numpy as np


def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float32 -> (H, W, 4) uint8 shared-exponent RGBE."""
    maxc = img.max(axis=-1)
    exp = np.zeros(maxc.shape, np.int32)
    nz = maxc >= 1e-32
    # frexp: maxc = f * 2^e with f in [0.5, 1)
    f, e = np.frexp(np.where(nz, maxc, 1.0))
    scale = f * 256.0 / np.where(nz, maxc, 1.0)
    rgbe = np.zeros(img.shape[:2] + (4,), np.uint8)
    mant = np.clip(img * scale[..., None], 0.0, 255.0)
    rgbe[..., :3] = np.where(nz[..., None], mant, 0.0).astype(np.uint8)
    exp = np.where(nz, e + 128, 0)
    rgbe[..., 3] = exp.astype(np.uint8)
    return rgbe


def write_hdr(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]
    rgbe = _float_to_rgbe(img)
    with open(path, "wb") as out:
        out.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        out.write(f"-Y {H} +X {W}\n".encode())
        if not (8 <= W < 32768):
            out.write(rgbe.tobytes())  # flat scanlines
            return
        for y in range(H):
            out.write(bytes([2, 2, (W >> 8) & 0xFF, W & 0xFF]))
            for c in range(4):
                comp = rgbe[y, :, c]
                x = 0
                while x < W:
                    # find a run of >= 3 equal bytes, else emit literals
                    run_start = x
                    while run_start < W:
                        run_len = 1
                        while (
                            run_start + run_len < W
                            and run_len < 127
                            and comp[run_start + run_len] == comp[run_start]
                        ):
                            run_len += 1
                        if run_len >= 3:
                            break
                        run_start += run_len
                    # literals before the run (chunks of <= 128)
                    lit_end = min(run_start, W)
                    while x < lit_end:
                        n = min(128, lit_end - x)
                        out.write(bytes([n]))
                        out.write(comp[x : x + n].tobytes())
                        x += n
                    if run_start < W and run_len >= 3:
                        out.write(bytes([128 + run_len, int(comp[run_start])]))
                        x = run_start + run_len
