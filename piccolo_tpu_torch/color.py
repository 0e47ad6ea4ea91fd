"""Colour harmonization preprocessing (port of piccolo_tpu/color.py).

``color_mod`` is the reference's joint image+cloud Y-channel histogram
equalization in YCrCb (reference ``color_utils.py:7-65``); ``color_match``
the sin-latitude-weighted per-channel CDF matching of the image to the
cloud colors (``color_utils.py:146-234``).  Both run on the host in numpy.

The JAX package converts to YCrCb with cv2 where it can.  The port has one
code path for every machine: the fixed-point integer formulas of cv2's
8-bit conversion, which equal cv2 bit for bit, in numpy on the host and in
torch on the device.

The device half serves tracked frames, where the host's per-pixel numpy
work would dwarf the short descent: :func:`color_match_device` and
:func:`color_mod_device`, from the room's precomputed
:func:`cloud_color_cdf` and :func:`cloud_sharpen_state`.  The JAX package
writes their histograms and LUT lookups as one-hot MXU dots (a TPU gathers
and scatters slowly); here the histograms come from the port's histogram
kernels (``block_histogram`` per image row, ``masked_histogram_counts``
for the Y channel) and the lookups are plain indexing.  On the CPU the
kernels' plain versions run.

Documented behaviour delta (shared with the JAX package): the reference's
``_match_cumulative_cdf`` indexes its per-intensity interpolant with
*unique-value* indices (``color_utils.py:201``), which misaligns whenever
some intensity bins are absent from the image; here each unique source
value is mapped to its own intensity bin explicitly.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "color_mod",
    "color_mod_device",
    "cloud_sharpen_state",
    "color_match",
    "color_match_device",
    "cloud_color_cdf",
    "interp",
    "rgb_to_ycrcb",
    "SharpenState",
    "SharpenTensors",
    "ycrcb_to_rgb",
]

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
    """Exact cv2 RGB->YCrCb on int32 channels (``xp`` numpy or torch)."""
    r, g, b = rgb_i[..., 0], rgb_i[..., 1], rgb_i[..., 2]
    y = _descale(r * _R2Y + g * _G2Y + b * _B2Y)
    cr = _descale((r - y) * _R2CR) + 128
    cb = _descale((b - y) * _B2CB) + 128
    return xp.clip(xp.stack([y, cr, cb], -1), 0, 255)


def _ycrcb2rgb_i32(ycc_i, xp=np):
    """Exact cv2 YCrCb->RGB on int32 channels (``xp`` numpy or torch)."""
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


# ---------------------------------------------------------------------------
# the device half (tracked frames)


def cloud_color_cdf(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel empirical CDF of the cloud colors, for device matching.

    The cloud side of :func:`color_match` (``np.unique`` + normalized
    cumulative counts, reference ``color_utils.py:208-214``) depends only
    on the room, so it is computed once here.

    Returns ``(values, quant)``, both ``(3, K)`` float32, where per channel
    ``quant[k] = P(color <= values[k])``.  Channels are padded to a common
    K by extending the last node with strictly increasing quant > 1 and the
    same value: :func:`interp` never sees duplicate nodes, and queries are
    <= 1, so the pads are inert.
    """
    vals, quants = [], []
    for c in range(3):
        v, cnt = np.unique(rgb[:, c], return_counts=True)
        vals.append(v.astype(np.float32))
        quants.append((np.cumsum(cnt) / rgb.shape[0]).astype(np.float32))
    k_max = max(v.shape[0] for v in vals)
    values = np.empty((3, k_max), np.float32)
    quant = np.empty((3, k_max), np.float32)
    for c in range(3):
        n = vals[c].shape[0]
        values[c, :n] = vals[c]
        quant[c, :n] = quants[c]
        if n < k_max:
            values[c, n:] = vals[c][-1]
            quant[c, n:] = quants[c][-1] + np.arange(
                1, k_max - n + 1, dtype=np.float32
            )
    return values, quant


class SharpenState(NamedTuple):
    """Room-static inputs of :func:`color_mod_device`, as host numpy arrays
    (the JAX package's layout, so both packages take the same state).

    ``color_mod`` couples the image and the cloud through ONE joint Y
    histogram, so its cloud side cannot be finished offline the way
    :func:`cloud_color_cdf` finishes ``color_match``'s, but everything the
    cloud contributes is static: its Y histogram and its YCrCb integer
    channels.  Rows past the true point count are zero one-hots with
    Cr = Cb = 128, which the device math maps to exact black.
    """

    y_hist: np.ndarray    # (256,) f32: cloud Y-bin counts (unpadded rows)
    oh_hi: np.ndarray     # (M, 16) f32: one-hot of Y>>4 per (padded) point
    oh_lo: np.ndarray     # (M, 16) f32: one-hot of Y&15
    crcb: np.ndarray      # (M, 2) f32: integer Cr/Cb channels (pads 128)


class SharpenTensors(NamedTuple):
    """A :class:`SharpenState` on a device, in the form the port indexes
    with (``convert.sharpen_state_from_numpy``)."""

    y_hist: torch.Tensor  # (256,) f32
    y: torch.Tensor       # (M,) int64 Y level of each point; 256 on pad rows
    crcb: torch.Tensor    # (M, 2) int32


def cloud_sharpen_state(
    rgb: np.ndarray, pad_to: int | None = None, num_bins: int = 256
) -> SharpenState:
    """Precompute the cloud side of :func:`color_mod` for device sharpening.

    Args:
      rgb: (N, 3) float cloud colors in [0, 1] (the room's UNPADDED colors:
        the histogram must not count padding rows).
      pad_to: pad the per-point arrays to this row count (the room's cloud
        size bucket) so the device output matches the padded cloud shape.
      num_bins: must be 256, as in the JAX package (the reference default,
        ``localize.py:27``); other values keep the host path.
    """
    if num_bins != 256:
        raise ValueError(
            f"color_mod_device supports num_bins=256 only (got {num_bins})"
        )
    cloud_i = rgb_to_ycrcb(
        (np.asarray(rgb) * 255).astype(np.uint8)
    ).astype(np.int32)
    y = cloud_i[:, 0]
    n = int(y.shape[0])
    m = n if pad_to is None else int(pad_to)
    if m < n:
        raise ValueError(f"pad_to={m} < cloud size {n}")
    # the host bin index trunc((y/255)*255) equals y for every uint8 y
    hist = np.bincount(y, minlength=256).astype(np.float32)
    oh_hi = np.zeros((m, 16), np.float32)
    oh_lo = np.zeros((m, 16), np.float32)
    rows = np.arange(n)
    oh_hi[rows, y >> 4] = 1.0
    oh_lo[rows, y & 15] = 1.0
    crcb = np.full((m, 2), 128.0, np.float32)
    crcb[:n] = cloud_i[:, 1:3]
    return SharpenState(y_hist=hist, oh_hi=oh_hi, oh_lo=oh_lo, crcb=crcb)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for increasing 1-D ``xp``: the same
    searchsorted, the same blend and its guard against a zero-width
    interval, and the same clamps to ``fp[0]`` / ``fp[-1]`` outside
    ``[xp[0], xp[-1]]``."""
    n = xp.shape[0]
    i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    f0, x0 = fp[i - 1], xp[i - 1]
    df = fp[i] - f0
    dx = xp[i] - x0
    delta = x - x0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def color_mod_device(img: torch.Tensor, state: SharpenTensors):
    """:func:`color_mod` on the image's device (tracked frames).

    The host sharpen reduces exactly to integer math: cv2's fixed-point
    YCrCb conversions, a joint 256-bin Y histogram and a 256-entry
    luminance LUT ``lut[k] = trunc(cdf[k] * 255)``.  The image's Y
    histogram over non-black pixels comes from the masked-histogram kernel
    (exact integer counts), the LUT from exact integer arithmetic
    ``(255 * cumsum) // total``, and both LUT applications (image pixels
    and cloud points) are plain indexing.

    Documented delta against the host, shared with the JAX package: the
    host computes the CDF in f64 (normalize, cumsum, scale), whose rounding
    can cross a truncation boundary where ``255 * cumsum`` is an exact
    multiple of the total; the integer floor here is the exact value.  At
    most one luminance level, at a tiny share of pixels.

    Args:
      img: (H, W, 3) f32 tensor in [0, 1].
      state: the room's state on the image's device
        (``convert.sharpen_state_from_numpy``).
    Returns:
      ``(img, rgb)``: the sharpened image (H, W, 3) f32 and the
      re-luminated (padded) cloud colors (M, 3) f32; pad rows are black.
    """
    from .kernels.histogram import masked_histogram_counts

    H, W, _ = img.shape
    img_i = (img * 255).to(torch.int32)  # truncation = reference .long()
    nonblack = img_i.sum(-1) > 0
    ycc = _rgb2ycrcb_i32(img_i, xp=torch).to(torch.int32)
    y = ycc[..., 0].reshape(-1).contiguous()
    img_hist = masked_histogram_counts(
        y, nonblack.reshape(-1).to(torch.float32), 256)
    # joint counts are exact integers in f32 (< 2^24)
    joint = (img_hist + state.y_hist).to(torch.int64)
    csum = torch.cumsum(joint, 0)
    # index 256 is the pad rows' level: it maps to 0, as the JAX package's
    # zero one-hot rows select 0
    lut = torch.cat([(255 * csum) // csum[-1], csum.new_zeros(1)]).to(
        torch.int32)

    y_img = lut[y.to(torch.int64)].reshape(H, W)
    new_rgb_i = _ycrcb2rgb_i32(torch.stack([y_img, ycc[..., 1], ycc[..., 2]],
                                           -1), xp=torch)
    img_out = torch.where(nonblack[..., None],
                          new_rgb_i.to(torch.float32) / 255.0, img)
    cloud_i = _ycrcb2rgb_i32(
        torch.stack([lut[state.y], state.crcb[:, 0], state.crcb[:, 1]], -1),
        xp=torch)
    return img_out.to(torch.float32), cloud_i.to(torch.float32) / 255.0


def color_match_device(img: torch.Tensor, cdf_values: torch.Tensor,
                       cdf_quant: torch.Tensor) -> torch.Tensor:
    """:func:`color_match` on the image's device (tracked frames).

    Same semantics as the host version: truncating 255-bin conversion,
    sin(latitude) pixel weights, per-channel weighted CDF matched to the
    cloud CDF by :func:`interp`, black pixels untouched.  The weight
    depends only on the image row, so the block-histogram kernel counts
    each (channel, row)'s bins over the non-black pixels, exactly, and one
    weighted sum over rows gives each channel's histogram.  The image-side
    quantiles are f32 here and f64 on the host; the noise (~1e-6 relative)
    is far below one cloud-CDF step.

    Args:
      img: (H, W, 3) f32 tensor in [0, 1].
      cdf_values / cdf_quant: (3, K) tensors from :func:`cloud_color_cdf`.
    Returns:
      (H, W, 3) f32 matched image.
    """
    from .kernels.block_histogram import block_histogram

    H, W, _ = img.shape
    img_i = (img * 255).to(torch.int32)  # truncation = reference .long()
    nonblack = img_i.sum(-1) > 0
    sin_w = torch.sin(torch.arange(H, dtype=torch.float32, device=img.device)
                      / H * math.pi)
    # (3H, W) rows of bin ids, channel-major; the mask repeats per channel
    ids = img_i.permute(2, 0, 1).reshape(3 * H, W).contiguous()
    mask = nonblack.to(torch.float32).repeat(3, 1).contiguous()
    counts = block_histogram(ids, mask, 256).reshape(3, H, 256)
    hist = (counts * sin_w[:, None]).sum(1)  # (3, 256)
    src_quant = torch.cumsum(hist, 1)
    src_quant = src_quant / src_quant[:, -1:]
    flat_i = img_i.reshape(-1, 3).to(torch.int64)
    flat = img.reshape(-1, 3)
    keep = nonblack.reshape(-1)
    out = []
    for c in range(3):
        lut = interp(src_quant[c].contiguous(), cdf_quant[c].contiguous(),
                     cdf_values[c])
        out.append(torch.where(keep, lut[flat_i[:, c]], flat[:, c]))
    return torch.stack(out, -1).reshape(H, W, 3).to(torch.float32)
