"""Order-statistic helpers (numpy port of piccolo_tpu.ops.quantile).

``order_quantile``/``cloud_bounds`` are the reference's argsort-based pair
(utils.py:208-254): the lower order statistic at index int(n*q), no
interpolation.  ``outside_box`` is the out-of-room gate against such a box,
``out_of_room`` the same gate from the cloud, and ``pose_search_bounds``
the 6-DoF box the reference hands an external optimizer.  All run on the
host: a tensor argument is copied there first.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["order_quantile", "cloud_bounds", "out_of_room", "outside_box",
           "pose_search_bounds"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


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


def pose_search_bounds(xyz, out_quantile: float = 0.05,
                       yaw=(0.0, 6.283185307179586),
                       pitch=(0.0, 3.141592653589793),
                       roll=(0.0, 6.283185307179586),
                       as_slices: bool = False):
    """6-DoF search bounds for external optimizers (the reference's
    ``get_bound``, utils.py:257-279): the translation box from the cloud's
    order quantiles and the given angle ranges.  A dict of (lo, hi) pairs,
    or six slices with ``as_slices``."""
    lo, hi = cloud_bounds(_host(xyz), out_quantile)
    lo = [float(v) for v in lo]
    hi = [float(v) for v in hi]
    if as_slices:
        return (
            slice(lo[0], hi[0]), slice(lo[1], hi[1]), slice(lo[2], hi[2]),
            slice(*yaw), slice(*pitch), slice(*roll),
        )
    return {
        "x": (lo[0], hi[0]), "y": (lo[1], hi[1]), "z": (lo[2], hi[2]),
        "yaw": tuple(yaw), "pitch": tuple(pitch), "roll": tuple(roll),
    }


def out_of_room(xyz, trans, q: float = 0.05) -> bool:
    """True if ``trans`` falls outside the cloud's quantile box (the
    reference's ``out_of_room``, utils.py:232-254: strict inequalities)."""
    lo, hi = cloud_bounds(_host(xyz), q)
    return outside_box(lo, hi, _host(trans))
