"""Baseline JPEG decoder, dependency-free (numpy only; counterpart of
shader_ray_tpu/utils/jpeg.py).

The reference loads backgrounds through FreeImagePlus, which decodes JPEG
(ray.cpp:1035-1074); its own golden images are JPEGs.  This module
decodes the baseline sequential Huffman DCT subset (SOF0/SOF1): 8-bit
samples, YCbCr or grayscale, any sampling factors, restart intervals,
8/16-bit quantization tables.  Progressive (SOF2), arithmetic coding,
12-bit and CMYK raise ``ValueError``.

Decode pipeline: entropy-decode MCUs (canonical Huffman, bit reader over
the destuffed scan), dequantize, 2-D IDCT over all blocks of a component
at once (8x8 DCT-III as one einsum), libjpeg's triangle upsampling of 2x
subsampled chroma, BT.601 YCbCr -> RGB.  The arithmetic is the reference
package's, operation for operation, so both give the same bytes.
"""

from __future__ import annotations

import numpy as np

# zig-zag order: index z of the scan -> (row, col) in the 8x8 block
_ZZ = np.array([
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# 8-point DCT-III basis: idct(X) = C^T X C with C[k, n] scaled
_C = np.zeros((8, 8), np.float64)
for _k in range(8):
    for _n in range(8):
        a = np.sqrt(0.125) if _k == 0 else 0.5
        _C[_k, _n] = a * np.cos((2 * _n + 1) * _k * np.pi / 16.0)


class _Huff:
    """Canonical Huffman table: decode via (length-indexed) range check
    — at most 16 compares per symbol."""

    def __init__(self, counts: np.ndarray, symbols: np.ndarray):
        self.min_code = np.zeros(17, np.int64)
        self.max_code = np.full(17, -1, np.int64)
        self.val_ptr = np.zeros(17, np.int64)
        self.symbols = symbols
        code = 0
        k = 0
        for ln in range(1, 17):
            n = int(counts[ln - 1])
            if n:
                self.val_ptr[ln] = k
                self.min_code[ln] = code
                self.max_code[ln] = code + n - 1
                k += n
                code += n
            code <<= 1


class _BitReader:
    """MSB-first bit reader over a destuffed entropy segment."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0

    def read_bit(self) -> int:
        b = int(self.bits[self.pos])
        self.pos += 1
        return b

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        v = 0
        bits = self.bits
        p = self.pos
        for _ in range(n):
            v = (v << 1) | int(bits[p])
            p += 1
        self.pos = p
        return v

    def decode(self, tbl: _Huff) -> int:
        code = 0
        bits = self.bits
        p = self.pos
        for ln in range(1, 17):
            code = (code << 1) | int(bits[p])
            p += 1
            if code <= tbl.max_code[ln]:
                self.pos = p
                return int(
                    tbl.symbols[tbl.val_ptr[ln] + code - tbl.min_code[ln]]
                )
        raise ValueError("invalid JPEG: bad Huffman code")


def _extend(v: int, t: int) -> int:
    """JPEG F.2.2.1 sign extension of a t-bit magnitude."""
    return v if t == 0 or v >= (1 << (t - 1)) else v - (1 << t) + 1


def decode_jpeg(data: bytes) -> np.ndarray:
    """bytes -> (H, W, 3) uint8 RGB (grayscale replicated)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI)")
    pos = 2
    qt: dict[int, np.ndarray] = {}
    huff_dc: dict[int, _Huff] = {}
    huff_ac: dict[int, _Huff] = {}
    frame = None
    restart_interval = 0

    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError("invalid JPEG: marker expected")
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        seg_len = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2 : pos + seg_len]
        pos += seg_len
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                prec, tid = seg[i] >> 4, seg[i] & 15
                i += 1
                if prec:
                    tbl = np.frombuffer(
                        seg[i : i + 128], ">u2"
                    ).astype(np.int32)
                    i += 128
                else:
                    tbl = np.frombuffer(
                        seg[i : i + 64], np.uint8
                    ).astype(np.int32)
                    i += 64
                qt[tid] = tbl
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                cls, tid = seg[i] >> 4, seg[i] & 15
                counts = np.frombuffer(seg[i + 1 : i + 17], np.uint8)
                n = int(counts.sum())
                symbols = np.frombuffer(seg[i + 17 : i + 17 + n], np.uint8)
                (huff_ac if cls else huff_dc)[tid] = _Huff(counts, symbols)
                i += 17 + n
        elif marker == 0xC0 or marker == 0xC1:  # SOF0/1 baseline
            prec = seg[0]
            if prec != 8:
                raise ValueError(f"unsupported JPEG precision {prec}")
            H = (seg[1] << 8) | seg[2]
            W = (seg[3] << 8) | seg[4]
            nc = seg[5]
            comps = []
            for c in range(nc):
                cid, samp, tq = seg[6 + 3 * c], seg[7 + 3 * c], seg[8 + 3 * c]
                comps.append(dict(
                    id=cid, h=samp >> 4, v=samp & 15, tq=tq,
                ))
            frame = dict(H=H, W=W, comps=comps)
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                        0xCB, 0xCD, 0xCE, 0xCF):
            raise ValueError(
                f"unsupported JPEG frame type SOF{marker & 15} "
                "(baseline sequential only)"
            )
        elif marker == 0xDD:  # DRI
            restart_interval = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("invalid JPEG: SOS before SOF")
            ns = seg[0]
            scan = []
            for c in range(ns):
                cs, tt = seg[1 + 2 * c], seg[2 + 2 * c]
                comp = next(
                    x for x in frame["comps"] if x["id"] == cs
                )
                scan.append((comp, tt >> 4, tt & 15))
            # entropy data runs until the next non-RST marker
            end = pos
            while True:
                end = data.index(b"\xff", end)
                m = data[end + 1]
                if m == 0x00 or 0xD0 <= m <= 0xD7:
                    end += 2
                    continue
                break
            ecs = data[pos:end]
            out = _decode_scan(
                frame, scan, qt, huff_dc, huff_ac, ecs, restart_interval
            )
            return out
    raise ValueError("invalid JPEG: no scan")


def _decode_scan(frame, scan, qt, huff_dc, huff_ac, ecs, restart_interval):
    H, W = frame["H"], frame["W"]
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-W // (8 * hmax))
    mcuy = -(-H // (8 * vmax))
    n_mcu = mcux * mcuy

    # destuff per restart segment (0xFF00 -> 0xFF; RST markers split)
    segments = []
    if restart_interval:
        parts = []
        cur = bytearray()
        i = 0
        while i < len(ecs):
            b = ecs[i]
            if b == 0xFF:
                nxt = ecs[i + 1] if i + 1 < len(ecs) else 0xD9
                if nxt == 0x00:
                    cur.append(0xFF)
                    i += 2
                    continue
                if 0xD0 <= nxt <= 0xD7:
                    parts.append(bytes(cur))
                    cur = bytearray()
                    i += 2
                    continue
            cur.append(b)
            i += 1
        parts.append(bytes(cur))
        segments = parts
    else:
        segments = [ecs.replace(b"\xff\x00", b"\xff")]

    # per-component block storage (full MCU-padded grids)
    store = []
    for comp, _, _ in scan:
        bx = mcux * comp["h"]
        by = mcuy * comp["v"]
        store.append(np.zeros((by * bx, 64), np.int32))

    seg_idx = 0
    rd = _BitReader(segments[0] + b"\xff\xff")  # pad guards bit overrun
    pred = [0] * len(scan)
    mcu_in_seg = 0
    for m in range(n_mcu):
        if restart_interval and mcu_in_seg == restart_interval:
            seg_idx += 1
            rd = _BitReader(segments[seg_idx] + b"\xff\xff")
            pred = [0] * len(scan)
            mcu_in_seg = 0
        mcu_in_seg += 1
        my, mx = divmod(m, mcux)
        for ci, (comp, tdc, tac) in enumerate(scan):
            dc_tbl = huff_dc[tdc]
            ac_tbl = huff_ac[tac]
            for by_ in range(comp["v"]):
                for bx_ in range(comp["h"]):
                    blk = np.zeros(64, np.int32)
                    t = rd.decode(dc_tbl)
                    diff = _extend(rd.read_bits(t), t)
                    pred[ci] += diff
                    blk[0] = pred[ci]
                    k = 1
                    while k < 64:
                        rs = rd.decode(ac_tbl)
                        r, s = rs >> 4, rs & 15
                        if s == 0:
                            if r == 15:
                                k += 16
                                continue
                            break  # EOB
                        k += r
                        if k > 63:
                            raise ValueError("invalid JPEG: AC overrun")
                        blk[k] = _extend(rd.read_bits(s), s)
                        k += 1
                    row = (my * comp["v"] + by_) * (mcux * comp["h"]) \
                        + mx * comp["h"] + bx_
                    store[ci][row] = blk

    # dequantize + IDCT, all blocks of a component at once
    planes = []
    for (comp, _, _), blocks in zip(scan, store):
        q = qt[comp["tq"]]
        deq = np.zeros((blocks.shape[0], 64), np.float64)
        deq[:, _ZZ] = blocks * q[None, :]
        b8 = deq.reshape(-1, 8, 8)
        spat = np.einsum("kn,bkl,lm->bnm", _C, b8, _C) + 128.0
        bx = mcux * comp["h"]
        by = mcuy * comp["v"]
        plane = (
            spat.reshape(by, bx, 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(by * 8, bx * 8)
        )
        # upsample to full MCU-grid resolution.  2x uses the triangle
        # filter (libjpeg's default "fancy" upsampler: out[2i] =
        # (3 c[i] + c[i-1]) / 4, out[2i+1] = (3 c[i] + c[i+1]) / 4,
        # edges replicated) so subsampled chroma matches the oracle;
        # other ratios (rare 4x) fall back to nearest
        ry, rx = vmax // comp["v"], hmax // comp["h"]
        plane = _upsample(plane, ry, axis=0)
        plane = _upsample(plane, rx, axis=1)
        planes.append(plane[:H, :W])

    if len(planes) == 1:
        y = np.clip(planes[0], 0, 255)
        return np.dstack([y, y, y]).astype(np.uint8)
    if len(planes) != 3:
        raise ValueError(f"unsupported JPEG component count {len(planes)}")
    y, cb, cr = planes
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.dstack([r, g, b]), 0, 255).astype(np.uint8)


def _upsample(plane: np.ndarray, r: int, axis: int) -> np.ndarray:
    if r == 1:
        return plane
    if r != 2:
        return plane.repeat(r, axis=axis)
    p = plane if axis == 0 else plane.T
    prev = np.vstack([p[:1], p[:-1]])
    nxt = np.vstack([p[1:], p[-1:]])
    out = np.empty((p.shape[0] * 2, p.shape[1]), p.dtype)
    out[0::2] = (3.0 * p + prev) * 0.25
    out[1::2] = (3.0 * p + nxt) * 0.25
    return out if axis == 0 else out.T


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
