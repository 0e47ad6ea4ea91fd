"""Pose error metrics and accuracy accounting (a copy of
piccolo_tpu/harness/metrics.py).

Parity with the reference's metric code (``localize.py:239-258``), including
the trace clamping for numerically invalid rotations.
"""

from __future__ import annotations

import numpy as np

__all__ = ["translation_error", "rotation_error_deg", "AccuracyTracker",
           "STANFORD_T_THRESH", "STANFORD_R_THRESH_DEG",
           "OMNISCENES_T_THRESH", "OMNISCENES_R_THRESH_DEG"]

STANFORD_T_THRESH = 0.2  # metres (localize.py:250)
STANFORD_R_THRESH_DEG = float(np.rad2deg(0.2))  # ~11.46 deg
OMNISCENES_T_THRESH = 0.1  # metres (localize.py:513)
OMNISCENES_R_THRESH_DEG = 5.0


def translation_error(gt_trans: np.ndarray, est_trans: np.ndarray) -> float:
    """Euclidean distance between (3,1)/(3,) translations."""
    return float(np.linalg.norm(np.asarray(gt_trans).ravel() - np.asarray(est_trans).ravel()))


def rotation_error_deg(gt_rot: np.ndarray, est_rot: np.ndarray) -> float:
    """Geodesic rotation error in degrees with the reference's clamping.

    trace(R_est^T R_gt) is folded back into the valid [-1, 3] range before
    the arccos (localize.py:242-247) to survive slightly non-orthonormal
    inputs.
    """
    tr = float(np.trace(np.asarray(est_rot).T @ np.asarray(gt_rot)))
    if tr < -1:
        tr = -2 - tr
    elif tr > 3:
        tr = 6 - tr
    return float(np.rad2deg(np.abs(np.arccos((tr - 1) / 2))))


class AccuracyTracker:
    """Running success-rate accounting (localize.py:250-258)."""

    def __init__(self, t_thresh: float, r_thresh_deg: float):
        self.t_thresh = t_thresh
        self.r_thresh_deg = r_thresh_deg
        self.well_posed = 0
        self.total = 0

    def update(self, t_error: float, r_error_deg: float) -> bool:
        ok = (t_error < self.t_thresh) and (r_error_deg < self.r_thresh_deg)
        self.well_posed += int(ok)
        self.total += 1
        return ok

    @property
    def accuracy(self) -> float:
        return self.well_posed / self.total if self.total else 0.0
