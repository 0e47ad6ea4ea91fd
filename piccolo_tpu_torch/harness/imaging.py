"""Host-side image IO: a stdlib PNG codec, a baseline JPEG codec and cv2's
bilinear resize (port of piccolo_tpu/harness/imaging.py).

The JAX package decodes and resizes with cv2 or PIL.  The port runs on
machines that have neither, so it carries its own:

* :func:`png_decode`: 8-bit grey, RGB and RGBA PNGs, not interlaced, all
  five row filters (``zlib`` inflates the stream; the filters are undone
  along anti-diagonals, whose pixels do not depend on one another).
  Anything else raises.  :func:`png_encode` writes 8-bit RGB with
  unfiltered rows.
* :func:`jpeg_decode`: baseline sequential Huffman JPEGs, 8-bit, 1 or 3
  components, 4:4:4, 4:2:2, 4:2:0 and 4:4:0 sampling, restart intervals
  and custom Huffman tables, decoded as libjpeg does by default (what
  ``cv2.imread`` uses): the ISLOW integer IDCT, "fancy" chroma upsampling
  and libjpeg's fixed-point YCbCr -> RGB, equal to cv2 bit for bit.  A grey
  image comes out as three equal channels.  Progressive, lossless,
  hierarchical, arithmetic-coded, 12-bit, RGB-coded, CMYK/YCCK and
  multi-scan files and an EXIF orientation other than 1 raise, naming what
  they are.
  :func:`jpeg_encode` writes baseline 4:2:0 JPEGs with the Annex K tables
  scaled by IJG quality (95 by default, as ``cv2.imwrite``).  The Huffman
  coding, DCTs and colour conversions run in C++
  (``csrc/jpeg_codec.cpp``, built with the host compiler at first use and
  called through ctypes, which releases the GIL: the prefetch thread
  decodes while the main thread drives the card); the marker parsing and
  writing are here.
* :func:`resize`: cv2's ``INTER_LINEAR`` on uint8, in its fixed-point
  form: 11-bit coefficients ``round((1 - f) * 2048)`` / ``round(f * 2048)``
  per tap, a horizontal pass in integers, then the vertical pass with the
  rounding shifts of cv2's vectorised path.  It equals ``cv2.resize`` bit
  for bit on downscales (integer factors and others); on upscales cv2's
  border rows can differ by one.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["imread_rgb", "imwrite_rgb", "png_decode", "png_encode",
           "jpeg_decode", "jpeg_encode", "resize", "vconcat"]

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> samples per pixel


def _unfilter(ftype: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of an (H, W, C) uint8 scanline array.

    Pixel (r, c) depends on its left, upper and upper-left neighbours only,
    so every anti-diagonal r + c = d is decoded at once."""
    if not ftype.any():
        return filt
    h, w, _ = filt.shape
    x = np.zeros((h + 1, w + 1, filt.shape[2]), np.int16)  # zero border
    f = filt.astype(np.int16)
    t = ftype.astype(np.int16)[:, None]
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a, b, cc = x[r + 1, c], x[r, c + 1], x[r, c]  # left, up, up-left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        tr = t[r]
        pred = np.select([tr == 0, tr == 1, tr == 2, tr == 3],
                         [np.zeros_like(a), a, b, (a + b) >> 1], paeth)
        x[r + 1, c + 1] = (f[r, c] + pred) & 255
    return x[1:, 1:].astype(np.uint8)


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB (grey is repeated, alpha dropped)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG or JPEG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, comp, filt_method, interlace = hdr
    if depth != 8 or color not in _CHANNELS or comp or filt_method:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{color} (8-bit grey, RGB and RGBA are decoded)")
    if interlace:
        raise ValueError("unsupported PNG: interlaced")
    n = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * n + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(h, w * n + 1)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError("PNG row filter type out of range")
    img = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, n))
    if n == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def png_encode(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (every row unfiltered)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"need (H, W, 3) uint8 pixels, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                         axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


_JPEG_SOI = b"\xff\xd8"
CODEC_SRC = Path(__file__).resolve().parent / "csrc" / "jpeg_codec.cpp"

# SOFn markers the decoder refuses, by what they are
_SOF_KINDS = {
    0xC2: "progressive JPEG", 0xC3: "lossless JPEG",
    0xC5: "hierarchical JPEG", 0xC6: "hierarchical JPEG",
    0xC7: "hierarchical JPEG", 0xC9: "arithmetic-coded JPEG",
    0xCA: "arithmetic-coded JPEG", 0xCB: "arithmetic-coded JPEG",
    0xCD: "arithmetic-coded JPEG", 0xCE: "arithmetic-coded JPEG",
    0xCF: "arithmetic-coded JPEG",
}


@functools.cache
def _codec():
    from ..kernels._build import load_host_library

    lib = load_host_library(CODEC_SRC)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.pj_decode.restype = ctypes.c_int
    lib.pj_decode.argtypes = [
        u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, ip, ip,
        ip, ip, ip, ctypes.POINTER(ctypes.c_uint16), u8p, u8p, u8p, u8p,
        ctypes.c_int, u8p, ctypes.c_char_p, ctypes.c_int]
    lib.pj_encode.restype = ctypes.c_long
    lib.pj_encode.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), u8p, u8p, u8p, ctypes.c_long]
    return lib


def _ptr(a: np.ndarray, ctype=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _exif_orientation(body: bytes):
    """The orientation tag (0x0112) of an APP1 Exif body, or None."""
    if body[:6] != b"Exif\x00\x00" or len(body) < 14:
        return None
    tiff = body[6:]
    end = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if end is None:
        return None
    (ifd,) = struct.unpack(end + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return None
    (n,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
    for i in range(n):
        e = ifd + 2 + 12 * i
        if e + 12 > len(tiff):
            break
        tag, typ = struct.unpack(end + "HH", tiff[e:e + 4])
        if tag == 0x0112 and typ == 3:
            return struct.unpack(end + "H", tiff[e + 8:e + 10])[0]
    return None


def jpeg_decode(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> (H, W, 3) uint8 RGB, as ``cv2.imread`` decodes
    them (grey comes out as three equal channels)."""
    if data[:2] != _JPEG_SOI:
        raise ValueError("not a JPEG file")
    qt = np.zeros((4, 64), np.uint16)
    tabs = {0: (np.zeros((4, 16), np.uint8), np.zeros((4, 256), np.uint8)),
            1: (np.zeros((4, 16), np.uint8), np.zeros((4, 256), np.uint8))}
    frame, restart, adobe, jfif = None, 0, None, False
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and (
                pos + 1 < len(data) and data[pos + 1] == 0xFF):
            pos += 1  # fill bytes
        if pos + 4 > len(data) or data[pos] != 0xFF:
            raise ValueError("JPEG ends before its scan")
        marker = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in _SOF_KINDS:
            raise ValueError(f"unsupported JPEG: {_SOF_KINDS[marker]} (only "
                             "baseline sequential Huffman JPEGs are decoded)")
        if marker == 0xCC:
            raise ValueError("unsupported JPEG: arithmetic-coded JPEG (only "
                             "baseline sequential Huffman JPEGs are decoded)")
        if marker in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"unsupported JPEG: {prec}-bit samples "
                                 "(only 8-bit JPEGs are decoded)")
            if nc == 4:
                raise ValueError("unsupported JPEG: CMYK/YCCK (4 components)")
            if nc not in (1, 3):
                raise ValueError(f"unsupported JPEG: {nc} components")
            comps = [tuple(body[6 + 3 * i:9 + 3 * i]) for i in range(nc)]
            frame = dict(h=h, w=w, comps=comps)
            if h == 0 or w == 0:
                raise ValueError("unsupported JPEG: zero size (DNL marker)")
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if tq > 3:
                    raise ValueError("corrupt JPEG: bad quantisation table")
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n],
                                     ">u2" if pq else np.uint8)
                qt[tq, _ZIGZAG] = vals
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                bits = np.frombuffer(body[i + 1:i + 17], np.uint8)
                n = int(bits.sum())
                vals = np.frombuffer(body[i + 17:i + 17 + n], np.uint8)
                # libjpeg's check: a DC symbol is a bit count, at most 15
                if tc > 1 or th > 3 or n > 256 or (tc == 0 and n
                                                    and vals.max() > 15):
                    raise ValueError("corrupt JPEG: bad Huffman table")
                tabs[tc][0][th] = bits
                tabs[tc][1][th] = 0
                tabs[tc][1][th, :n] = vals
                i += 17 + n
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xE1:
            orient = _exif_orientation(body)
            if orient not in (None, 1):
                raise ValueError(f"unsupported JPEG: EXIF orientation "
                                 f"{orient} (only orientation 1 is decoded)")
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            break
        elif marker == 0xD9:
            raise ValueError("JPEG ends before its scan")
    if frame is None:
        raise ValueError("JPEG scan without a baseline frame header")
    ns = body[0]
    if ns != len(frame["comps"]):
        raise ValueError("unsupported JPEG: multi-scan (a scan without "
                         "every component)")
    sel = {body[1 + 2 * i]: body[2 + 2 * i] for i in range(ns)}
    nc = len(frame["comps"])
    for cid, samp, tq_ in frame["comps"]:
        if not (cid in sel and 1 <= samp >> 4 <= 4 and 1 <= samp & 15 <= 4
                and tq_ < 4 and sel[cid] >> 4 < 4 and sel[cid] & 15 < 4):
            raise ValueError("corrupt JPEG: a component's sampling factors "
                             "or table selectors are out of range")
    hs = np.array([c[1] >> 4 for c in frame["comps"]], np.int32)
    vs = np.array([c[1] & 15 for c in frame["comps"]], np.int32)
    tq = np.array([c[2] for c in frame["comps"]], np.int32)
    td = np.array([sel[c[0]] >> 4 for c in frame["comps"]], np.int32)
    ta = np.array([sel[c[0]] & 15 for c in frame["comps"]], np.int32)
    ids = bytes(c[0] for c in frame["comps"])
    # libjpeg's colour-space guess: three components are YCbCr unless an
    # Adobe marker or the component ids say RGB
    if nc == 3 and not jfif and (adobe == 0 or (adobe is None
                                                 and ids == b"RGB")):
        raise ValueError("unsupported JPEG: RGB-coded (only grey and YCbCr "
                         "JPEGs are decoded)")
    scan = np.frombuffer(data, np.uint8)[pos:]
    h, w = frame["h"], frame["w"]
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    rc = _codec().pj_decode(
        _ptr(scan), scan.size, w, h, nc, _ptr(hs, ctypes.c_int),
        _ptr(vs, ctypes.c_int), _ptr(tq, ctypes.c_int),
        _ptr(td, ctypes.c_int), _ptr(ta, ctypes.c_int),
        _ptr(qt, ctypes.c_uint16), _ptr(tabs[0][0]), _ptr(tabs[0][1]),
        _ptr(tabs[1][0]), _ptr(tabs[1][1]), restart, _ptr(out), err,
        len(err))
    if rc:
        raise ValueError(f"unsupported JPEG: {err.value.decode()}")
    return out


# ITU T.81 Annex K: the example quantisation tables (natural order) and
# the typical Huffman tables (K.3), which cv2 and libjpeg also write
_STD_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_STD_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    np.int64)
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
_STD_HUFF = (  # (bits, values): luma DC, luma AC, chroma DC, chroma AC
    ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
)


def _quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG's jpeg_quality_scaling of an Annex K table, clamped to 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.uint16)


def jpeg_encode(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JPEG bytes: JFIF, YCbCr 4:2:0, the
    Annex K tables scaled by IJG ``quality`` and the typical Huffman
    tables."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"need (H, W, 3) uint8 pixels, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a JPEG side must be 1..65535, got {w}x{h}")
    qt = np.stack([_quality_table(_STD_Q_LUMA, quality),
                   _quality_table(_STD_Q_CHROMA, quality)])
    bits = np.zeros((4, 16), np.uint8)
    vals = np.zeros((4, 256), np.uint8)
    for i, (b, v) in enumerate(_STD_HUFF):
        bits[i] = b
        vals[i, :len(v)] = list(v)
    cap = h * w * 4 + 1024
    out = np.empty(cap, np.uint8)
    n = _codec().pj_encode(_ptr(img), w, h, 1, _ptr(qt, ctypes.c_uint16),
                           _ptr(bits), _ptr(vals), _ptr(out), cap)
    if n < 0:
        raise RuntimeError("JPEG entropy data outgrew its buffer")

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    dqt = b"".join(bytes([i]) + qt[i][_ZIGZAG].astype(np.uint8).tobytes()
                   for i in range(2))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(bytes([(i & 1) << 4 | i >> 1]) + bits[i].tobytes()
                   + vals[i, :int(bits[i].sum())].tobytes() for i in range(4))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (_JPEG_SOI
            + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + seg(0xDB, dqt) + seg(0xC0, sof) + seg(0xC4, dht)
            + seg(0xDA, sos) + out[:n].tobytes() + b"\xff\xd9")


def imread_rgb(path: str) -> np.ndarray:
    """Read a PNG or JPEG file (by its leading bytes) -> (H, W, 3) uint8
    RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == _JPEG_SOI:
        return jpeg_decode(data)
    return png_decode(data)


def imwrite_rgb(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB to a PNG, or to a JPEG at quality 95 (as
    ``cv2.imwrite``), by the path's extension."""
    ext = path.lower().rsplit(".", 1)[-1]
    if ext == "png":
        data = png_encode(img)
    elif ext in ("jpg", "jpeg"):
        data = jpeg_encode(img)
    else:
        raise ValueError(f"only PNG and JPEG files are written here, got "
                         f"{path!r}")
    with open(path, "wb") as f:
        f.write(data)


_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(dst: int, src: int):
    """cv2's INTER_LINEAR taps along one axis: (i0, i1, a0, a1) with
    integer weights a0 + a1 = 2048 (float32 positions, cvRound)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    low = i0 < 0
    f[low], i0[low] = 0, 0
    high = i0 >= src - 1
    f[high], i0[high] = 0, src - 1
    a0 = np.rint((np.float32(1) - f) * _COEF_SCALE).astype(np.int64)
    a1 = np.rint(f * _COEF_SCALE).astype(np.int64)
    return i0, np.minimum(i0 + 1, src - 1), a0, a1


def resize(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """Resize an (H, W, C) uint8 image to (W, H) with cv2's bilinear
    interpolation."""
    if img.shape[1] == size_wh[0] and img.shape[0] == size_wh[1]:
        return img
    W, H = size_wh
    im = img.astype(np.int64)
    x0, x1, ax0, ax1 = _linear_taps(W, img.shape[1])
    y0, y1, ay0, ay1 = _linear_taps(H, img.shape[0])
    # horizontal pass: values scaled by 2048
    d = im[:, x0] * ax0[None, :, None] + im[:, x1] * ax1[None, :, None]
    # vertical pass, as cv2's vectorised uint8 path rounds it
    v = (((d[y0] >> 4) * ay0[:, None, None]) >> 16) + (
        ((d[y1] >> 4) * ay1[:, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def vconcat(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    return np.concatenate([top, bottom], axis=0)
