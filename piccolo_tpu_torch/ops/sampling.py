"""Bilinear image sampling with grid_sample-parity semantics (port of
piccolo_tpu.ops.sampling).

  * unnormalise: p = ((c + 1) * size - 1) / 2   (align_corners=False)
  * corners outside the image contribute zero (zeros padding)
  * incoming coords are clipped to [-0.99, 0.99] first
  * ``floor`` contributes no gradient: the pose gradient flows through the
    lerp weights only, as in grid_sample's backward
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import on_card

__all__ = [
    "bilinear_sample",
    "pack_bilinear_blocks",
    "bilinear_sample_packed",
    "packed_rows_and_weights",
    "cast_packed_table",
    "resolve_descent_table",
    "AUTO_BF16_TABLE_BYTES",
    "AUTO_BF16_TABLE_BYTES_CARD",
]

# ``descent_table = auto`` flips the descent's table to bf16 texels once the
# f32 table would exceed this footprint: the JAX package's threshold, which
# holds off the card
AUTO_BF16_TABLE_BYTES = 64 * 10**6
# the same on the card.  H100 80GB HBM3, 700 W (scripts/measure_admission.py,
# PERF.md's routing-values table, row 5): a graphed 6 x 100 descent of
# 65,536 points steps 16-19% faster on bf16 than on f32 at 6.3, 25, 101 and
# 403 MB (1.02 M points at 403 MB: 27%), at the same median t_err over 8
# poses at 6.3 and 25 MB; tables under the smallest size measured keep f32
AUTO_BF16_TABLE_BYTES_CARD = 6 * 10**6

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
}


def resolve_descent_table(dtype_str: str, height: int, width: int,
                          device=None) -> str:
    """``auto`` -> ``bfloat16`` when the packed f32 table exceeds
    :data:`AUTO_BF16_TABLE_BYTES`, or on a CUDA ``device``
    :data:`AUTO_BF16_TABLE_BYTES_CARD`, else ``float32``; explicit dtypes
    pass through."""
    if dtype_str != "auto":
        return dtype_str
    limit = (AUTO_BF16_TABLE_BYTES_CARD if on_card(device)
             else AUTO_BF16_TABLE_BYTES)
    rows = (height + 1) * (width + 1)
    return "bfloat16" if rows * 48 > limit else "float32"


def _clip_coords(coords, clip: bool, wrap: bool):
    if wrap:
        # wrap x into [-1, 1) before the pixel transform; y keeps the clip
        x_n = torch.remainder(coords[..., 0] + 1.0, 2.0) - 1.0
        y_n = coords[..., 1].clamp(-0.99, 0.99) if clip else coords[..., 1]
    elif clip:
        c = coords.clamp(-0.99, 0.99)
        x_n, y_n = c[..., 0], c[..., 1]
    else:
        x_n, y_n = coords[..., 0], coords[..., 1]
    return x_n, y_n


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor,
                    clip: bool = True, wrap: bool = False) -> torch.Tensor:
    """Sample (H, W, C) ``img`` at (..., 2) normalised ``coords`` with four
    row gathers; returns (..., C), zero where all four corners are outside.
    ``wrap`` wraps x across the equirect seam instead of clipping it."""
    H, W, C = img.shape
    x_n, y_n = _clip_coords(coords, clip, wrap)
    x = ((x_n + 1.0) * W - 1.0) / 2.0
    y = ((y_n + 1.0) * H - 1.0) / 2.0
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = x - x0f
    wx0 = 1.0 - wx1
    wy1 = y - y0f
    wy0 = 1.0 - wy1
    flat = img.reshape(H * W, C)

    def tap(ix, iy, w):
        if wrap:
            valid = (iy >= 0) & (iy < H)
            ixc = torch.remainder(ix, W)
        else:
            valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            ixc = ix.clamp(0, W - 1)
        iyc = iy.clamp(0, H - 1)
        vals = flat[iyc * W + ixc]
        return vals * (w * valid)[..., None]

    return (
        tap(x0, y0, wx0 * wy0)
        + tap(x1, y0, wx1 * wy0)
        + tap(x0, y1, wx0 * wy1)
        + tap(x1, y1, wx1 * wy1)
    )


def pack_bilinear_blocks(img: torch.Tensor, wrap: bool = False) -> torch.Tensor:
    """((H+1)*(W+1), 12) table of every anchor's 2x2 texel neighbourhood.

    Row r = (y0+1)*(W+1) + (x0+1) holds [tex(y0,x0), tex(y0,x0+1),
    tex(y0+1,x0), tex(y0+1,x0+1)] for y0 in [-1, H-1], x0 in [-1, W-1]; the
    zero border reproduces grid_sample's zeros padding.  ``wrap=True`` puts
    the opposite edge's texels in the x padding columns instead.
    """
    H, W, C = img.shape
    if wrap:
        pr = F.pad(img, (0, 0, 0, 0, 1, 1))  # zero rows (poles)
        P = torch.cat([pr[:, -1:], pr, pr[:, :1]], dim=1)
    else:
        P = F.pad(img, (0, 0, 1, 1, 1, 1))
    blocks = torch.cat(
        [P[:-1, :-1], P[:-1, 1:], P[1:, :-1], P[1:, 1:]], dim=-1
    )
    return blocks.reshape((H + 1) * (W + 1), 4 * C)


def cast_packed_table(blocks: torch.Tensor, dtype: str) -> torch.Tensor:
    """Narrow the texel dtype: ``float32`` exact, ``bfloat16``, or ``uint8``
    fixed point x/255 (clipped to [0, 1] first).  0.0 stays 0 exactly."""
    tdtype = _DTYPES[dtype]
    if tdtype == torch.uint8:
        return torch.round(blocks.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return blocks.to(tdtype)


def packed_rows_and_weights(coords: torch.Tensor, height: int, width: int,
                            clip: bool = True, wrap: bool = False):
    """(row, wx1, wy1): int32 row into :func:`pack_bilinear_blocks`' table
    and the fractions of the (x1, y1) taps.  Shared by the descent's
    sampler and the slab planner so both floor to the same texel."""
    H, W = height, width
    x_n, y_n = _clip_coords(coords, clip, wrap)
    x = ((x_n + 1.0) * W - 1.0) / 2.0
    y = ((y_n + 1.0) * H - 1.0) / 2.0
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    row = (y0f.to(torch.int32) + 1) * (W + 1) + (x0f.to(torch.int32) + 1)
    return row, x - x0f, y - y0f


def bilinear_sample_packed(blocks: torch.Tensor, height: int, width: int,
                           coords: torch.Tensor, clip: bool = True,
                           wrap: bool = False,
                           row_offset=None) -> torch.Tensor:
    """One gather per point from a packed table; equal to
    :func:`bilinear_sample` on the image that produced ``blocks``.

    ``row_offset``: K tables of one (height, width) stacked into ``blocks``
    ((K * rows, 12)); an int32 offset broadcast against ``coords``' leading
    dims (e.g. (K, 1), k * rows) picks each stream's table."""
    row, wx1, wy1 = packed_rows_and_weights(coords, height, width, clip, wrap)
    if row_offset is not None:
        row = row + row_offset
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    g = blocks[row.to(torch.int64)]
    if g.dtype == torch.uint8:
        g = g.to(torch.float32) * (1.0 / 255.0)
    C = blocks.shape[-1] // 4
    return (
        g[..., 0:C] * (wx0 * wy0)[..., None]
        + g[..., C:2 * C] * (wx1 * wy0)[..., None]
        + g[..., 2 * C:3 * C] * (wx0 * wy1)[..., None]
        + g[..., 3 * C:] * (wx1 * wy1)[..., None]
    )
