"""Point-cloud text loading (port of piccolo_tpu/data/loader.py).

Clouds are whitespace-delimited ``x y z r g b`` text.  The JAX package
parses them with a g++-built C++ parser or pandas; here ``np.loadtxt``
parses them into float64, which needs neither.  A native parser can come
back if a measurement shows that load time matters.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["load_txt_pointcloud", "subsample"]


def load_txt_pointcloud(filepath: str,
                        sample_rate: float = 1.0) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """Load an ``x y z r g b`` text cloud.

    Returns (xyz (N,3) float64, rgb (N,3) float64 in [0,1]); colors in the
    file are 0..255.  ``sample_rate > 1`` keeps N/sample_rate random points
    via a permutation of np.random's global stream, as the JAX package and
    the reference do (reference data_utils.py:36-41).
    """
    data = np.loadtxt(filepath, dtype=np.float64, ndmin=2)
    xyz = np.ascontiguousarray(data[:, :3], dtype=np.float64)
    rgb = np.ascontiguousarray(data[:, 3:6], dtype=np.float64) / 255.0
    return subsample(xyz, rgb, sample_rate)


def subsample(xyz: np.ndarray, rgb: np.ndarray,
              sample_rate: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    if sample_rate > 1.0:
        perm = np.random.permutation(xyz.shape[0])
        idx = perm[: int(xyz.shape[0] / sample_rate)]
        xyz = xyz[idx]
        rgb = rgb[idx]
    return xyz, rgb
