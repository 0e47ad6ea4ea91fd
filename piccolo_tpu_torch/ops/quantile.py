"""Order-statistic helpers (numpy port of piccolo_tpu.ops.quantile).

``order_quantile``/``cloud_bounds`` are the reference's argsort-based pair
(utils.py:208-254): the lower order statistic at index int(n*q), no
interpolation.  ``outside_box`` is the out-of-room gate against such a box.
"""

from __future__ import annotations

import numpy as np

__all__ = ["order_quantile", "cloud_bounds", "outside_box"]


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


def outside_box(lo, hi, trans) -> bool:
    """True unless ``trans`` lies strictly inside the (lo, hi) box (the
    reference's out_of_room gate, utils.py:232-254)."""
    t = np.asarray(trans).reshape(-1)[:3]
    return not bool(np.all((t > np.asarray(lo)) & (t < np.asarray(hi))))
