"""Colour harmonization preprocessing, the host half (port of
piccolo_tpu/color.py's ``color_mod`` and ``color_match``).

``color_mod`` is the reference's joint image+cloud Y-channel histogram
equalization in YCrCb (reference ``color_utils.py:7-65``); ``color_match``
the sin-latitude-weighted per-channel CDF matching of the image to the
cloud colors (``color_utils.py:146-234``).  Both run on the host in numpy.

The JAX package converts to YCrCb with cv2 where it can.  The port has one
code path for every machine: the numpy fixed-point integer formulas of
cv2's 8-bit conversion, which equal cv2 bit for bit.  The device half
(``color_mod_device``, ``color_match_device``) belongs to the tracking
slice of the port.

Documented behaviour delta (shared with the JAX package): the reference's
``_match_cumulative_cdf`` indexes its per-intensity interpolant with
*unique-value* indices (``color_utils.py:201``), which misaligns whenever
some intensity bins are absent from the image; here each unique source
value is mapped to its own intensity bin explicitly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["color_mod", "color_match", "rgb_to_ycrcb", "ycrcb_to_rgb"]

# cv2's 8-bit YCrCb conversion is FIXED-POINT: 14-bit coefficients with a
# round-half-up descale ``(x + 2^13) >> 14`` (OpenCV color.cpp; YCRF=0.713,
# YCBF=0.564 and the inverse 1.403/0.714/0.344/1.773 scaled by 2^14).
# Replicating the integer math exactly matches cv2 bit for bit (the JAX
# package verifies it over all 256^3 inputs in both directions,
# tests/test_color.py).  All intermediates fit int32.
_R2Y, _G2Y, _B2Y = 4899, 9617, 1868
_R2CR, _B2CB = 11682, 9241
_CR2R, _CR2G, _CB2G, _CB2B = 22987, -11698, -5636, 29049


def _descale(x):
    """cv2's CV_DESCALE(x, 14): round-half-up arithmetic shift."""
    return (x + (1 << 13)) >> 14


def _rgb2ycrcb_i32(rgb_i, xp=np):
    """Exact cv2 RGB->YCrCb on int32 channels."""
    r, g, b = rgb_i[..., 0], rgb_i[..., 1], rgb_i[..., 2]
    y = _descale(r * _R2Y + g * _G2Y + b * _B2Y)
    cr = _descale((r - y) * _R2CR) + 128
    cb = _descale((b - y) * _B2CB) + 128
    return xp.clip(xp.stack([y, cr, cb], -1), 0, 255)


def _ycrcb2rgb_i32(ycc_i, xp=np):
    """Exact cv2 YCrCb->RGB on int32 channels."""
    y, cr, cb = ycc_i[..., 0], ycc_i[..., 1], ycc_i[..., 2]
    r = y + _descale((cr - 128) * _CR2R)
    g = y + _descale((cr - 128) * _CR2G + (cb - 128) * _CB2G)
    b = y + _descale((cb - 128) * _CB2B)
    return xp.clip(xp.stack([r, g, b], -1), 0, 255)


def rgb_to_ycrcb(rgb_u8: np.ndarray) -> np.ndarray:
    """uint8 RGB -> uint8 YCrCb with cv2's fixed formulas."""
    return _rgb2ycrcb_i32(rgb_u8.astype(np.int32)).astype(np.uint8)


def ycrcb_to_rgb(ycc_u8: np.ndarray) -> np.ndarray:
    """uint8 YCrCb -> uint8 RGB with cv2's fixed formulas."""
    return _ycrcb2rgb_i32(ycc_u8.astype(np.int32)).astype(np.uint8)


def color_mod(
    img: np.ndarray, rgb: np.ndarray, num_bins: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    """Sharpen colors by joint Y-histogram equalization.

    Args:
      img: (H, W, 3) float image in [0, 1].
      rgb: (N, 3) float cloud colors in [0, 1].
      num_bins: luminance histogram bins (reference default 256).

    Returns:
      (img, rgb) both modified, same shapes/dtypes/ranges.
    """
    H, W, _ = img.shape
    flat = img.reshape(-1, 3).copy()
    nonblack = (flat * 255).astype(np.int64).sum(-1) > 0

    tgt = rgb_to_ycrcb((flat[nonblack] * 255).astype(np.uint8)) / 255.0
    cloud = rgb_to_ycrcb((rgb * 255).astype(np.uint8)) / 255.0

    img_y_hist = np.bincount(
        (tgt[:, 0] * (num_bins - 1)).astype(np.int64), minlength=num_bins
    ).astype(np.float64)
    rgb_y_hist = np.bincount(
        (cloud[:, 0] * (num_bins - 1)).astype(np.int64), minlength=num_bins
    ).astype(np.float64)

    tot = img_y_hist + rgb_y_hist
    tot /= tot.sum()
    cdf = np.cumsum(tot)

    tgt[:, 0] = cdf[(tgt[:, 0] * (num_bins - 1)).astype(np.int64)]
    cloud[:, 0] = cdf[(cloud[:, 0] * (num_bins - 1)).astype(np.int64)]

    new_tgt = ycrcb_to_rgb((tgt * 255).astype(np.uint8)) / 255.0
    new_cloud = ycrcb_to_rgb((cloud * 255).astype(np.uint8)) / 255.0

    flat[nonblack] = new_tgt
    return flat.reshape(H, W, 3).astype(np.float32), new_cloud.astype(np.float32)


def _match_cdf_channel(
    src_bins: np.ndarray, template: np.ndarray, weight: np.ndarray
) -> np.ndarray:
    """Weighted CDF matching of one channel (src as int bins in [0, 255])."""
    counts = np.bincount(src_bins, weights=weight)
    src_quant = np.cumsum(counts)
    src_quant = src_quant / src_quant[-1]

    tmp_values, tmp_counts = np.unique(template, return_counts=True)
    tmp_quant = np.cumsum(tmp_counts) / template.shape[0]

    # np.interp clamps outside [xp[0], xp[-1]] — the same endpoint behaviour
    # the reference's periodic extension produces for in-[0,1] data.
    mapped = np.interp(src_quant, tmp_quant, tmp_values)
    return mapped[src_bins].astype(np.float32)


def color_match(img: np.ndarray, rgb: np.ndarray) -> np.ndarray:
    """Match the image's per-channel CDF to the cloud colors.

    Pixels are weighted by sin(latitude) to undo equirectangular
    oversampling at the poles (reference color_utils.py:220-221). Black
    pixels are left untouched.

    Args:
      img: (H, W, 3) float image in [0, 1].
      rgb: (N, 3) float cloud colors in [0, 1].
    Returns:
      (H, W, 3) float32 image in [0, 1].
    """
    H, W, _ = img.shape
    flat = np.array(img.reshape(-1, 3), dtype=np.float32)
    # ONE truncating int conversion serves the black mask and all three
    # channel-bin lookups (the repeated 2M-pixel int64 astypes dominated the
    # preprocessing wall time otherwise). int truncation matches the
    # reference's .long() semantics.
    flat_i = (flat * 255).astype(np.int32)
    nonblack = flat_i.sum(-1) > 0
    rows = np.repeat(np.arange(H, dtype=np.float32), W)
    sin_w = np.sin(rows / H * np.pi)

    src_i = flat_i[nonblack]
    w = sin_w[nonblack]

    matched = np.empty((src_i.shape[0], 3), np.float32)
    for c in range(3):
        matched[:, c] = _match_cdf_channel(src_i[:, c], rgb[:, c], w)

    flat[nonblack] = matched
    return flat.reshape(H, W, 3)
