"""Order-statistic helpers (numpy port of piccolo_tpu.ops.quantile).

``order_quantile``/``cloud_bounds`` are the reference's argsort-based pair
(utils.py:208-254): the lower order statistic at index int(n*q), no
interpolation.
"""

from __future__ import annotations

import numpy as np

__all__ = ["order_quantile", "cloud_bounds"]


def order_quantile(x: np.ndarray, q: float):
    """(sorted[int(n*q)], sorted[int(n*(1-q))]) of a 1-D array."""
    n = x.shape[0]
    s = np.sort(x)
    return s[int(n * q)], s[int(n * (1 - q))]


def cloud_bounds(xyz: np.ndarray, q: float = 0.05):
    """Per-axis (lo, hi) clamp box of an (N, 3) cloud from order quantiles."""
    n = xyz.shape[0]
    s = np.sort(xyz, axis=0)
    return s[int(n * q)], s[int(n * (1 - q))]
