"""Host-side image IO: a stdlib PNG codec and cv2's bilinear resize, in
numpy (port of piccolo_tpu/harness/imaging.py).

The JAX package decodes and resizes with cv2 or PIL.  The port runs on
machines that have neither, so it carries its own:

* :func:`png_decode`: 8-bit grey, RGB and RGBA PNGs, not interlaced, all
  five row filters (``zlib`` inflates the stream; the filters are undone
  along anti-diagonals, whose pixels do not depend on one another).
  Anything else raises.  JPEG is not decoded: datasets whose panoramas are
  JPEG (OmniScenes) wait for a decoder.  :func:`png_encode` writes 8-bit
  RGB with unfiltered rows.
* :func:`resize`: cv2's ``INTER_LINEAR`` on uint8, in its fixed-point
  form: 11-bit coefficients ``round((1 - f) * 2048)`` / ``round(f * 2048)``
  per tap, a horizontal pass in integers, then the vertical pass with the
  rounding shifts of cv2's vectorised path.  It equals ``cv2.resize`` bit
  for bit on downscales (integer factors and others); on upscales cv2's
  border rows can differ by one.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

__all__ = ["imread_rgb", "imwrite_rgb", "png_decode", "png_encode",
           "resize", "vconcat"]

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
        raise ValueError("not a PNG file (only PNG is decoded here; JPEG "
                         "decoding is not ported)")
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


def imread_rgb(path: str) -> np.ndarray:
    """Read a PNG file -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return png_decode(f.read())


def imwrite_rgb(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB to a PNG file."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"only PNG files are written here, got {path!r}")
    with open(path, "wb") as f:
        f.write(png_encode(img))


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
