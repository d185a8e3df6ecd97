"""Dependency-free PNG encode/decode (counterpart of
shader_ray_tpu/utils/png.py).

``encode_png`` writes the browser viewer's frames (app/webview.py):
8-bit RGB, filter 0 rows, one IDAT chunk.  ``decode_png`` reads the PNG
backgrounds ``models.background.load_background`` accepts: 8-bit,
non-interlaced, every colour type and row filter.  Input that is not such
a PNG raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (filter 0, one IDAT).

    ``level`` trades compression for speed; the live viewer favours
    latency.  Float frames quantize exactly like ppm.write_ppm (clip to
    [0, 1], round half up to u8), so the live view matches screenshots."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png: need (H, W, 3), got {img.shape}")
    h, w, _ = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    # filter byte 0 prepended per row, then one flat buffer
    rows = np.empty((h, 1 + w * 3), np.uint8)
    rows[:, 0] = 0
    rows[:, 1:] = img.reshape(h, w * 3)
    return (
        _SIG
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # per PNG color type


def _unfilter(rows: np.ndarray, w: int, bpp: int) -> np.ndarray:
    """Undo per-row PNG filters 0-4 over (H, 1 + w*bpp) u8 rows.
    Sub (1) vectorizes as a per-channel cumulative sum mod 256;
    Average (3) and Paeth (4) carry a left dependence and run a
    per-byte loop (a background loads once)."""
    h = rows.shape[0]
    n = w * bpp
    out = np.zeros((h, n), np.int32)
    prev = np.zeros(n, np.int32)
    for y in range(h):
        f, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 1:  # Sub: cumsum within each channel phase
            cur = line.reshape(-1, bpp)
            cur = (np.cumsum(cur, axis=0, dtype=np.int64) & 0xFF).reshape(n)
            cur = cur.astype(np.int32)
        elif f == 2:  # Up
            cur = (line + prev) & 0xFF
        elif f == 3:  # Average
            cur = line.copy()
            for x in range(n):
                a = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((a + prev[x]) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            cur = line.copy()
            for x in range(n):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {f}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8.

    Baseline 8-bit non-interlaced PNG: color types 0 (gray), 2 (RGB),
    3 (palette), 4 (gray+alpha), 6 (RGBA), row filters 0-4.  Alpha is
    dropped and gray broadcast: the background path wants plain RGB (the
    reference's FreeImagePlus ConvertTo24Bits, ray.cpp:1056-1067)."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos = 8
    w = h = ctype = None
    idat = b""
    plte = None
    while pos + 8 <= len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB", body)
            if depth != 8 or comp != 0 or filt != 0 or inter != 0:
                raise ValueError(
                    "decode_png handles 8-bit non-interlaced only "
                    f"(depth={depth}, interlace={inter})"
                )
            if ctype not in _CHANNELS:
                raise ValueError(f"unsupported PNG color type {ctype}")
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    if ctype is None:
        raise ValueError("PNG without IHDR chunk")
    raw = zlib.decompress(idat)
    bpp = _CHANNELS[ctype]
    stride = 1 + w * bpp
    if len(raw) != h * stride:
        raise ValueError(f"PNG image data of {len(raw)} bytes, need {h * stride}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
    px = _unfilter(rows, w, bpp).reshape(h, w, bpp)
    if ctype == 2:
        return px
    if ctype == 6:
        return np.ascontiguousarray(px[..., :3])
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE chunk")
        return plte[px[..., 0]]
    # gray / gray+alpha -> broadcast luminance
    return np.repeat(px[..., :1], 3, axis=2)
