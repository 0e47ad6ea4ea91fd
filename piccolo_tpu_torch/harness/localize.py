"""Room preparation helpers of the harness (port of the three helpers of
piccolo_tpu.harness.localize that the fused query needs); the harness and
CLI themselves belong to a later slice of the port."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..convert import cloud_from_numpy
from ..ops.quantile import cloud_bounds

__all__ = ["_bucket", "_pad_cloud", "_order_bounds"]


def _bucket(n: int, base: int = 4096) -> int:
    """Smallest bucket >= n from {base * 2^k, base * 3*2^(k-1)}."""
    b = base
    while b < n:
        if b * 3 // 2 >= n:
            return b * 3 // 2
        b *= 2
    return b


def _pad_cloud(xyz: np.ndarray, rgb: np.ndarray,
               device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cloud padded with zeros to its bucket, plus the validity mask, as
    tensors on ``device``."""
    n = xyz.shape[0]
    pad = _bucket(n) - n
    xyz_p = np.concatenate([xyz, np.zeros((pad, 3), xyz.dtype)])
    rgb_p = np.concatenate([rgb, np.zeros((pad, 3), rgb.dtype)])
    mask = np.arange(n + pad) < n
    return cloud_from_numpy(xyz_p, rgb_p, mask, device)


def _order_bounds(xyz: np.ndarray, q: float) -> Tuple[np.ndarray, np.ndarray]:
    """Order-quantile clamp box on the host from the unpadded cloud."""
    lo, hi = cloud_bounds(xyz, q)
    return lo.astype(np.float32), hi.astype(np.float32)
