"""The port's image readers and writers against the JAX package's, byte
for byte on the same generated files: PNG (every colour type, every row
filter; the encoder), BMP (8-bit palette, 24- and 32-bit, bottom-up and
top-down), TGA (raw and RLE, colour and gray, both row orders), baseline
JPEG (PIL-made: 4:4:4, 4:2:2 and 4:2:0, odd sizes, gray, restart
intervals) and the RGBE writer.  Also ``load_background``'s routing by
extension (the same float images as the reference's loader), the
``ValueError`` on a progressive JPEG and on a broken PNG, and that the
committed ``tests/assets/sky.jpg.npy`` is the JAX package's decode of
``tests/assets/sky.jpg`` (``chip_smoke.py`` holds the port to it on the
card's machine, which has neither JAX nor PIL)."""

import os
import struct
import zlib

import numpy as np
import pytest

from shader_ray_tpu.models import background as ref_background
from shader_ray_tpu.models import ldr as ref_ldr
from shader_ray_tpu.utils import hdr as ref_hdr
from shader_ray_tpu.utils import jpeg as ref_jpeg
from shader_ray_tpu.utils import png as ref_png
from shader_ray_tpu_torch.models import background, ldr
from shader_ray_tpu_torch.utils import hdr, jpeg, png

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def _pixels(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Seeded pixels with flat runs (RLE, Sub/Up filters) and noise."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
    img[: h // 3] = img[0, 0]  # a flat band
    return img


# ---------------------------------------------------------------- PNG


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_file(px: np.ndarray, ctype: int, plte: np.ndarray | None = None) -> bytes:
    """An 8-bit PNG of ``px`` (H, W, channels), row y filtered with filter
    y % 5, so every filter type appears."""
    h, w, bpp = px.shape
    raw = bytearray()
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        cur = px[y].reshape(-1).astype(np.int32)
        f = y % 5
        out = np.empty_like(cur)
        for x in range(cur.size):
            a = cur[x - bpp] if x >= bpp else 0
            c = prev[x - bpp] if x >= bpp else 0
            pred = (0, a, prev[x], (a + prev[x]) >> 1, _paeth(a, prev[x], c))[f]
            out[x] = (cur[x] - pred) & 0xFF
        raw += bytes([f]) + out.astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if plte is not None:
        body += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    # the image data split over two IDAT chunks
    z = zlib.compress(bytes(raw))
    body += chunk(b"IDAT", z[: len(z) // 2]) + chunk(b"IDAT", z[len(z) // 2:])
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b"")


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_decode_matches_the_reference(ctype):
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    px = _pixels(11, 13, channels, seed=ctype)
    plte = None
    if ctype == 3:
        plte = np.random.default_rng(1).integers(0, 256, size=(256, 3))
    data = _png_file(px, ctype, plte)
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (11, 13, 3)
    np.testing.assert_array_equal(got, ref_png.decode_png(data))
    want = {0: np.repeat(px, 3, 2), 2: px, 3: None, 4: np.repeat(px[..., :1], 3, 2), 6: px[..., :3]}[ctype]
    if ctype == 3:
        want = plte.astype(np.uint8)[px[..., 0]]
    np.testing.assert_array_equal(got, want)


def test_png_encode_matches_the_reference_and_round_trips():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, size=(33, 47, 3), dtype=np.uint8)
    frame = rng.uniform(-0.1, 1.1, size=(9, 5, 3)).astype(np.float32)
    sub = img[::2, 1:, :]  # not contiguous
    for x in (img, frame, sub):
        assert png.encode_png(x) == ref_png.encode_png(x)
    assert np.array_equal(png.decode_png(png.encode_png(img)), img)
    assert np.array_equal(png.decode_png(png.encode_png(sub)), sub)
    q = (np.clip(frame, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)  # as ppm.write_ppm
    assert np.array_equal(png.decode_png(png.encode_png(frame)), q)


# ---------------------------------------------------------------- BMP


def _bmp_file(px: np.ndarray, bpp: int, top_down: bool) -> bytes:
    """A BITMAPINFOHEADER BMP of ``px`` (H, W, 3); 8-bit through a palette
    of its distinct colours."""
    h, w, _ = px.shape
    palette = b""
    if bpp == 8:
        colors, idx = np.unique(px.reshape(-1, 3), axis=0, return_inverse=True)
        rows = idx.reshape(h, w).astype(np.uint8)
        palette = np.concatenate([colors[:, ::-1], np.zeros((len(colors), 1), np.uint8)], 1).tobytes()
        used = len(colors)
    else:
        nb = bpp // 8
        rows = np.zeros((h, w, nb), np.uint8)
        rows[..., :3] = px[..., ::-1]
        if nb == 4:
            rows[..., 3] = 200
        rows = rows.reshape(h, w * nb)
        used = 0
    stride = (rows.shape[1] + 3) & ~3
    pad = np.zeros((h, stride), np.uint8)
    pad[:, : rows.shape[1]] = rows
    if not top_down:
        pad = pad[::-1]
    pix = pad.tobytes()
    off = 14 + 40 + len(palette)
    header = b"BM" + struct.pack("<IHHI", off + len(pix), 0, 0, off)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, 0, len(pix),
                       2835, 2835, used, 0)
    return header + info + palette + pix


@pytest.mark.parametrize("bpp", [8, 24, 32])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_matches_the_reference(tmp_path, bpp, top_down):
    px = _pixels(7, 9, 3, seed=bpp)
    if bpp == 8:
        px = (px // 64) * 64  # few enough colours for a palette
    path = tmp_path / "img.bmp"
    path.write_bytes(_bmp_file(px, bpp, top_down))
    got = ldr.read_bmp(str(path))
    np.testing.assert_array_equal(got, ref_ldr.read_bmp(str(path)))
    np.testing.assert_array_equal(got, px)


# ---------------------------------------------------------------- TGA


def _rle(px: np.ndarray) -> bytes:
    """TGA RLE packets of (n, nb) pixels: runs of equal pixels as run
    packets, the rest as raw packets, at most 128 pixels a packet."""
    out, i, n = bytearray(), 0, len(px)
    while i < n:
        j = i
        while j + 1 < n and j + 1 - i < 128 and (px[j + 1] == px[i]).all():
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + px[i].tobytes()
            i = j + 1
            continue
        j = i
        while j + 1 < n and j + 1 - i < 128 and not (px[j + 1] == px[j]).all():
            j += 1
        out += bytes([j - i]) + px[i:j + 1].tobytes()
        i = j + 1
    return bytes(out)


def _tga_file(px: np.ndarray, img_type: int, top_down: bool) -> bytes:
    h, w, c = px.shape
    gray = img_type in (3, 11)
    data = px if gray else np.concatenate([px[..., 2::-1], px[..., 3:]], -1)  # RGB(A) -> BGR(A)
    if not top_down:
        data = data[::-1]
    flat = np.ascontiguousarray(data).reshape(h * w, c)
    body = _rle(flat) if img_type >= 10 else flat.tobytes()
    ident = b"seed"
    header = struct.pack("<BBBHHBHHHHBB", len(ident), 0, img_type, 0, 0, 0, 0, 0, w, h,
                         8 * c, 0x20 if top_down else 0)
    return header + ident + body


TGA_CASES = [(2, 3, False), (2, 4, True), (10, 3, True), (10, 4, False), (3, 1, False),
             (11, 1, True)]


@pytest.mark.parametrize("img_type,channels,top_down", TGA_CASES)
def test_tga_matches_the_reference(tmp_path, img_type, channels, top_down):
    px = _pixels(6, 10, channels, seed=img_type + channels)
    path = tmp_path / "img.tga"
    path.write_bytes(_tga_file(px, img_type, top_down))
    got = ldr.read_tga(str(path))
    np.testing.assert_array_equal(got, ref_ldr.read_tga(str(path)))
    np.testing.assert_array_equal(got, np.repeat(px, 3, 2) if channels == 1 else px[..., :3])


# ---------------------------------------------------------------- JPEG

JPEG_CASES = {
    "444": dict(size=(40, 24), mode="RGB", subsampling=0),
    "422-odd": dict(size=(37, 21), mode="RGB", subsampling=1),
    "420-odd": dict(size=(45, 27), mode="RGB", subsampling=2),
    "gray-odd": dict(size=(19, 13), mode="L"),
    "420-restart": dict(size=(50, 34), mode="RGB", subsampling=2, restart_marker_blocks=2),
    "gray-restart-rows": dict(size=(33, 40), mode="L", restart_marker_rows=1),
}


def _jpeg_file(path, case: str, progressive: bool = False) -> None:
    Image = pytest.importorskip("PIL.Image")
    opts = dict(JPEG_CASES[case])
    w, h = opts.pop("size")
    mode = opts.pop("mode")
    px = _pixels(h, w, 3, seed=w * h)
    y, x = np.mgrid[0:h, 0:w]
    px[..., 0] = (x * 255 // w).astype(np.uint8)  # smooth ramps beside the noise
    px[..., 2] = (y * 255 // h).astype(np.uint8)
    Image.fromarray(px).convert(mode).save(path, quality=80, progressive=progressive, **opts)


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_matches_the_reference(tmp_path, case):
    path = str(tmp_path / "img.jpg")
    _jpeg_file(path, case)
    got = jpeg.read_jpeg(path)
    want = ref_jpeg.read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if "restart" in case:
        assert b"\xff\xdd" in open(path, "rb").read()  # a DRI marker: restarts were written


def test_progressive_jpeg_and_broken_png_raise_value_error(tmp_path):
    path = str(tmp_path / "img.jpg")
    _jpeg_file(path, "420-odd", progressive=True)
    with pytest.raises(ValueError, match="SOF2"):
        jpeg.read_jpeg(path)
    with pytest.raises(ValueError, match="SOF2"):
        ref_jpeg.read_jpeg(path)
    with pytest.raises(ValueError, match="SOF2"):  # no PIL fallback
        background.load_background(path)
    (tmp_path / "sky.png").write_bytes(b"\x89PNG")
    with pytest.raises(ValueError, match="not a PNG"):
        background.load_background(str(tmp_path / "sky.png"))


def test_committed_jpeg_decode_is_the_references():
    path = os.path.join(ASSETS, "sky.jpg")
    want = ref_jpeg.read_jpeg(path)
    stored = np.load(path + ".npy")
    assert stored.dtype == np.uint8 and stored.shape == want.shape == (96, 192, 3)
    np.testing.assert_array_equal(stored, want)
    np.testing.assert_array_equal(jpeg.read_jpeg(path), want)
    data = open(path, "rb").read()
    sof = data.index(b"\xff\xc0")  # baseline, three components, luma 2x2 (4:2:0)
    assert data[sof + 9] == 3 and data[sof + 11] == 0x22 and data[sof + 14] == 0x11


# ---------------------------------------------------------------- HDR


@pytest.mark.parametrize("width", [5, 40])  # flat scanlines below 8, RLE from 8
def test_write_hdr_matches_the_reference(tmp_path, width):
    rng = np.random.default_rng(width)
    img = rng.uniform(0.0, 8.0, size=(6, width, 3)).astype(np.float32)
    img[:, : width // 2] = [0.5, 1.0, 2.0]  # runs
    img[0, 0] = 0.0
    hdr.write_hdr(str(tmp_path / "a.hdr"), img)
    ref_hdr.write_hdr(str(tmp_path / "b.hdr"), img)
    assert (tmp_path / "a.hdr").read_bytes() == (tmp_path / "b.hdr").read_bytes()
    back = background.read_hdr(str(tmp_path / "a.hdr"))
    # a shared 8-bit exponent: each component within 2^-7 of its pixel's largest
    assert (np.abs(back - img).max(-1) <= img.max(-1) / 128).all()


# ------------------------------------------------------- load_background


def test_load_background_routes_every_image_extension_as_the_reference(tmp_path):
    px = _pixels(8, 16, 3, seed=3)
    files = {
        "png": png.encode_png(px),
        "bmp": _bmp_file(px, 24, False),
        "dib": _bmp_file(px, 32, True),
        "tga": _tga_file(px, 10, False),
        "icb": _tga_file(px, 2, True),
        "vda": _tga_file(px, 2, False),
        "vst": _tga_file(px, 10, True),
    }
    for ext, data in files.items():
        (tmp_path / f"sky.{ext}").write_bytes(data)
    jpg = str(tmp_path / "sky.jpg")
    _jpeg_file(jpg, "420-odd")
    for ext in ("jpeg", "jfif"):
        (tmp_path / f"sky.{ext}").write_bytes(open(jpg, "rb").read())
    for ext in (*files, "jpg", "jpeg", "jfif"):
        spec = str(tmp_path / f"sky.{ext}")
        got, want = background.load_background(spec), ref_background.load_background(spec)
        assert got.dtype == np.float32 and got.dtype == want.dtype, ext
        np.testing.assert_array_equal(got, want, err_msg=ext)
        if ext not in ("jpg", "jpeg", "jfif"):
            np.testing.assert_array_equal(got, px.astype(np.float32) / 255.0, err_msg=ext)
    (tmp_path / "sky.tif").write_bytes(b"II*\x00")
    with pytest.raises(ValueError, match=r"\.jpg"):
        background.load_background(str(tmp_path / "sky.tif"))
