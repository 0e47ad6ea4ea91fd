"""A GIF89a writer in numpy and the standard library, for the optimisation
GIFs of ``visualize = True`` (the JAX package writes them with PIL, which
the port does not need).

Every frame is quantized to one fixed 256-colour palette, 8 levels of red,
8 of green and 4 of blue, each channel to its nearest level
(:func:`quantize`, :data:`PALETTE`), and coded with GIF's variable-width
LZW (9 to 12 bits, a clear code when the table is full).  The file loops
forever and shows each frame ``duration_ms``.  A decoder gives back
``PALETTE[quantize(frame)]`` exactly.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

__all__ = ["PALETTE", "quantize", "encode_gif"]

_LEVELS = (8, 8, 4)  # red, green, blue: 8 * 8 * 4 = 256 colours


def _level_values(n: int) -> np.ndarray:
    return (np.arange(n) * 255 + (n - 1) // 2) // (n - 1)


def _palette() -> np.ndarray:
    i = np.arange(256)
    r, g, b = i // 32, (i // 4) % 8, i % 4
    return np.stack([_level_values(8)[r], _level_values(8)[g],
                     _level_values(4)[b]], axis=-1).astype(np.uint8)


PALETTE = _palette()


def quantize(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 palette indices, each channel to
    its nearest level (halves round up)."""
    f = np.asarray(frame)
    if f.dtype != np.uint8 or f.ndim != 3 or f.shape[2] != 3:
        raise ValueError(f"need (H, W, 3) uint8 frames, got {f.dtype} "
                         f"{f.shape}")
    f = f.astype(np.int32)
    idx = [(f[..., c] * (n - 1) + 127) // 255 for c, n in enumerate(_LEVELS)]
    return ((idx[0] * _LEVELS[1] + idx[1]) * _LEVELS[2] + idx[2]).astype(
        np.uint8)


def _lzw(data: bytes, min_size: int = 8) -> bytes:
    """GIF's LZW code stream of ``data`` (one byte a pixel): a clear code
    first, codes of 9 bits widening to 12, a clear code whenever the table
    holds 4,096 codes, the end code last; bits packed least significant
    first."""
    clear = 1 << min_size
    end = clear + 1
    out = bytearray()
    acc, nacc = clear, min_size + 1  # the bit accumulator and its bits
    size, nxt = min_size + 1, end + 1
    table = {}
    it = iter(data)
    prefix = next(it)
    for c in it:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        acc |= prefix << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
        if nxt < 4096:
            table[key] = nxt
            if nxt == 1 << size:
                size += 1
            nxt += 1
        else:
            acc |= clear << nacc
            nacc += size
            table.clear()
            size, nxt = min_size + 1, end + 1
        prefix = c
    for code in (prefix, end):
        acc |= code << nacc
        nacc += size
    while nacc > 0:
        out.append(acc & 0xFF)
        acc >>= 8
        nacc -= 8
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    """``data`` as GIF data sub-blocks of at most 255 bytes, then the
    terminator."""
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
             for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def encode_gif(frames: Sequence[np.ndarray], duration_ms: int = 150) -> bytes:
    """An animated GIF89a of equal-sized (H, W, 3) uint8 frames, looping
    forever, each frame shown ``duration_ms`` (in GIF's hundredths of a
    second)."""
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    h, w = np.asarray(frames[0]).shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a GIF side must be 1..65535, got {w}x{h}")
    delay = int(round(duration_ms / 10))
    out = [b"GIF89a",
           # screen: global table of 2 ** (7 + 1) colours, 8 bits a primary
           struct.pack("<HHBBB", w, h, 0xF7, 0, 0), PALETTE.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for f in frames:
        if np.asarray(f).shape[:2] != (h, w):
            raise ValueError("every GIF frame must have the first's size")
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08")
        out.append(_sub_blocks(_lzw(quantize(f).tobytes())))
    out.append(b"\x3b")
    return b"".join(out)
