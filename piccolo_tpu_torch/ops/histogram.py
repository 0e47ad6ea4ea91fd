"""Masked colour histograms and histogram intersection (port of
piccolo_tpu.ops.histogram).

Bins: values in [0, 255], per-channel bin size ceil(255 / n_bins), flat id
r + Br*g + Br*Bg*b.  Counts are integers summed in f32, exact below 2^24.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

__all__ = [
    "bin_ids",
    "masked_histogram",
    "histogram_intersection",
    "block_histograms",
]


def bin_ids(img255: torch.Tensor, bins: Sequence[int] = (8, 8, 8)) -> torch.Tensor:
    """(..., 3) values in [0, 255] -> flat int32 bin ids in [0, prod(bins))."""
    bs = [math.ceil(255.0 / b) for b in bins]
    v = img255.to(torch.int32)
    r = v[..., 0] // bs[0]
    g = v[..., 1] // bs[1]
    b = v[..., 2] // bs[2]
    return r + bins[0] * g + bins[0] * bins[1] * b


def masked_histogram(img255: torch.Tensor, mask: torch.Tensor,
                     bins: Sequence[int] = (8, 8, 8),
                     normalize: bool = True,
                     use_kernel: bool = False) -> torch.Tensor:
    """Flat (prod(bins),) histogram of the masked pixels.  ``use_kernel``
    routes through ``kernels.histogram`` (the CUDA kernel on the card), as
    ``use_pallas`` routes the JAX package's through its Pallas kernel."""
    nb = math.prod(bins)
    ids = bin_ids(img255, bins).reshape(-1)
    m = mask.reshape(-1).to(torch.float32)
    if use_kernel:
        from ..kernels.histogram import masked_histogram_counts

        hist = masked_histogram_counts(ids.contiguous(), m.contiguous(), nb)
    else:
        hist = torch.zeros(nb, dtype=torch.float32, device=m.device)
        hist.index_add_(0, ids.to(torch.int64), m)
    if normalize:
        hist = hist / hist.sum().clamp_min(1e-12)
    return hist


def histogram_intersection(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Sum of elementwise minima: flat (C,) pairs give a scalar, batched
    (B, C) pairs one value per row."""
    if h1.dim() > 1:
        h1 = h1.reshape(h1.shape[0], -1)
        h2 = h2.reshape(h2.shape[0], -1)
    else:
        h1 = h1.reshape(-1)
        h2 = h2.reshape(-1)
    return torch.minimum(h1, h2).sum(-1)


def block_histograms(img255: torch.Tensor, mask: torch.Tensor,
                     bins: Sequence[int], num_split_h: int,
                     num_split_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block masked histograms of an (H, W, 3) image tiled into
    num_split_h x num_split_w blocks of (H // sh, W // sw) from the top
    left; remainder rows/cols fall outside every block.

    Returns (sh*sw, prod(bins)) counts and the (sh*sw,) masked pixel counts.
    """
    H, W, _ = img255.shape
    sh, sw = num_split_h, num_split_w
    bh, bw = H // sh, W // sw
    nb = math.prod(int(b) for b in bins)
    dev = img255.device
    ids = bin_ids(img255, bins)
    row = torch.arange(H, device=dev)[:, None] // bh
    col = torch.arange(W, device=dev)[None, :] // bw
    in_grid = (row < sh) & (col < sw)
    block = row.clamp(0, sh - 1) * sw + col.clamp(0, sw - 1)
    m = (mask & in_grid).to(torch.float32).reshape(-1)
    flat = (block * nb + ids).reshape(-1)
    hists = torch.zeros(sh * sw * nb, dtype=torch.float32, device=dev)
    hists.index_add_(0, flat, m)
    hists = hists.reshape(sh * sw, nb)
    return hists, hists.sum(-1)
