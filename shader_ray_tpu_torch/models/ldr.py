"""Dependency-free LDR image readers for background maps (counterpart
of shader_ray_tpu/models/ldr.py).

The reference loads any FreeImagePlus ``FIT_BITMAP`` format for LDR
backgrounds and converts to 24-bit RGB (ray.cpp:1056-1067).  BMP and TGA
are read here, PNG in utils/png.py, JPEG in utils/jpeg.py and PPM in
utils/ppm.py; there is no PIL fallback.  All readers return (H, W, 3)
uint8, row 0 = top scanline (float/255, no gamma linearization
downstream in load_background), and raise ``ValueError`` on a variant
they do not read.
"""

from __future__ import annotations

import struct

import numpy as np


def read_bmp(path: str) -> np.ndarray:
    """Windows BMP -> (H, W, 3) uint8.

    Supports the uncompressed (BI_RGB) encodings that cover virtually
    every .bmp in the wild: 24/32-bit truecolor and 8-bit palette,
    bottom-up (positive height) and top-down (negative height) rows,
    4-byte row padding, BITMAPINFOHEADER and the larger V4/V5 headers.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (pix_off,) = struct.unpack_from("<I", data, 10)
    (hdr_size,) = struct.unpack_from("<I", data, 14)
    if hdr_size < 40:
        raise ValueError(f"{path}: BITMAPCOREHEADER BMP not supported")
    w, h_signed = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    (compression,) = struct.unpack_from("<I", data, 30)
    if compression not in (0, 3):  # BI_RGB / BI_BITFIELDS-as-default
        raise ValueError(f"{path}: compressed BMP (type {compression})")
    top_down = h_signed < 0
    h = abs(h_signed)
    if w <= 0 or h == 0:
        raise ValueError(f"{path}: bad BMP dimensions {w}x{h_signed}")

    if bpp == 8:
        # palette: (used or 256) BGRA entries right after the DIB header
        (used,) = struct.unpack_from("<I", data, 46)
        n = used or 256
        pal = np.frombuffer(
            data, np.uint8, count=n * 4, offset=14 + hdr_size
        ).reshape(n, 4)[:, :3][:, ::-1]  # BGRA -> RGB
        stride = (w + 3) & ~3
        idx = np.frombuffer(
            data, np.uint8, count=h * stride, offset=pix_off
        ).reshape(h, stride)[:, :w]
        img = pal[idx]
    elif bpp in (24, 32):
        nb = bpp // 8
        stride = (w * nb + 3) & ~3
        rows = np.frombuffer(
            data, np.uint8, count=h * stride, offset=pix_off
        ).reshape(h, stride)
        px = rows[:, : w * nb].reshape(h, w, nb)
        img = px[..., :3][..., ::-1]  # BGR(A) -> RGB
    else:
        raise ValueError(f"{path}: {bpp}-bit BMP not supported")
    if not top_down:
        img = img[::-1]
    return np.ascontiguousarray(img)


def _tga_unrle(buf: np.ndarray, count: int, nb: int) -> np.ndarray:
    """TGA RLE stream -> (count, nb) u8 pixels."""
    out = np.empty((count, nb), np.uint8)
    p = 0
    i = 0
    while i < count:
        hdr = int(buf[p])
        p += 1
        n = (hdr & 0x7F) + 1
        if hdr & 0x80:  # run packet: one pixel repeated
            out[i : i + n] = buf[p : p + nb]
            p += nb
        else:  # raw packet
            out[i : i + n] = buf[p : p + n * nb].reshape(n, nb)
            p += n * nb
        i += n
    return out


def read_tga(path: str) -> np.ndarray:
    """Truevision TGA -> (H, W, 3) uint8.

    Supports truecolor (type 2) and RLE truecolor (10) at 24/32 bpp,
    plus grayscale (3/11); both row orders (descriptor bit 5).  These
    are the encodings everything that writes .tga emits."""
    with open(path, "rb") as f:
        data = f.read()
    idlen, cmap_type, img_type = data[0], data[1], data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    bpp, desc = data[16], data[17]
    if img_type not in (2, 3, 10, 11):
        raise ValueError(f"{path}: TGA image type {img_type} not supported")
    gray = img_type in (3, 11)
    if gray and bpp != 8:
        raise ValueError(f"{path}: {bpp}-bit grayscale TGA not supported")
    if not gray and bpp not in (24, 32):
        raise ValueError(f"{path}: {bpp}-bit truecolor TGA not supported")
    if cmap_type:
        raise ValueError(f"{path}: palette TGA not supported")
    nb = bpp // 8
    off = 18 + idlen
    buf = np.frombuffer(data, np.uint8, offset=off)
    if img_type >= 10:  # RLE
        px = _tga_unrle(buf, w * h, nb)
    else:
        px = buf[: w * h * nb].reshape(w * h, nb)
    px = px.reshape(h, w, nb)
    img = np.repeat(px, 3, axis=2) if gray else px[..., :3][..., ::-1]
    if not (desc & 0x20):  # bit 5 clear = bottom-up
        img = img[::-1]
    return np.ascontiguousarray(img)
