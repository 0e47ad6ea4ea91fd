"""Pose-candidate generation (host-side, numpy).

The port's own copy of piccolo_tpu.init.candidates (importing that module
would import JAX through the package's __init__); the code is unchanged.

Re-implements the reference's candidate grids (reference:
``utils.py:282-422``): translation grids sized adaptively to the cloud's
extent, rotation grids (yaw-only or full ypr meshgrid) with
duplicate-rotation filtering via the rotated sampling-grid fingerprint
(``utils.py:321-360, 702-755``).

Candidate counts are data-dependent, so this stage runs on the host in
numpy; everything downstream is static-shape JAX.  Two deliberate behaviour
fixes vs the reference (SURVEY §2 "latent bugs"):
  * duplicate-rotation filtering keeps the FIRST occurrence in grid order
    (the reference dedups through an unordered Python ``set``, making the
    candidate order nondeterministic across processes);
  * ``sample_rate_for_init`` subsampling masks xyz AND rgb together (the
    reference masks only xyz, which crashes downstream when the rate is set).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "adaptive_trans_num",
    "generate_trans_points",
    "generate_rot_points",
    "compute_sampling_grid",
    "default_init_dict",
]


def default_init_dict(**overrides) -> Dict:
    """The ~22-key init-hyperparameter dict (reference localize.py:18-73)."""
    d = dict(
        xy_only=True,
        num_trans=50,
        yaw_only=True,
        num_yaw=4,
        num_pitch=0,
        num_roll=0,
        max_yaw=2 * np.pi,
        min_yaw=0.0,
        max_pitch=2 * np.pi,
        min_pitch=0.0,
        max_roll=2 * np.pi,
        min_roll=0.0,
        x_max=None,
        x_min=None,
        y_max=None,
        y_min=None,
        z_max=None,
        z_min=None,
        z_prior=None,
        dataset="Stanford2D-3D-S",
        sample_rate_for_init=None,
        trans_init_mode="quantile",
        num_split_h=2,
        num_split_w=4,
    )
    d.update(overrides)
    return d


def adaptive_trans_num(
    xyz: np.ndarray, max_trans_num: int, xy_only: bool = False
) -> Tuple[int, ...]:
    """Split a translation budget across axes proportionally to cloud extent.

    Parity with reference ``utils.adaptive_trans_num`` (utils.py:282-318):
    extents from the 10th/90th linear-interp percentiles; the 3-D variant
    forces odd counts.
    """
    xyz_max = np.quantile(xyz, 0.90, axis=0)
    xyz_min = np.quantile(xyz, 0.10, axis=0)
    lx, ly, lz = (xyz_max - xyz_min).tolist()

    if xy_only:
        nx = math.ceil((lx * max_trans_num / ly) ** 0.5)
        ny = math.ceil((ly * max_trans_num / lx) ** 0.5)
        return nx, ny

    nx = math.ceil((lx**2 * max_trans_num / (ly * lz)) ** (1 / 3))
    ny = math.ceil((ly**2 * max_trans_num / (lx * lz)) ** (1 / 3))
    nz = math.ceil((lz**2 * max_trans_num / (lx * ly)) ** (1 / 3))
    if nx % 2 == 0:
        nx -= 1
    if ny % 2 == 0:
        ny -= 1
    if nz % 2 == 0:
        nz -= 1
    return nx, ny, nz


def _axis_points(xyz_col, n, mode, lo=None, hi=None):
    if mode == "uniform":
        return (np.arange(n) + 1) / (n + 1) * (
            xyz_col.max() - xyz_col.min()
        ) + xyz_col.min()
    if mode == "manual":
        return np.arange(n) / (n - 1) * (hi - lo) + lo
    # default: quantile (reference utils.py:386-393)
    split = (
        (np.arange(n) + 1) / (n + 1)
        if 1 / (n + 1) > 0.1
        else np.linspace(0.1, 0.9, n)
    )
    return np.quantile(xyz_col, split)


def generate_trans_points(xyz: np.ndarray, init_dict: Dict) -> np.ndarray:
    """(K, 3) translation starting points (reference utils.py:363-422)."""
    mode = init_dict["trans_init_mode"]
    if init_dict["xy_only"]:
        if init_dict["dataset"] not in ("Stanford2D-3D-S", "OmniScenes"):
            raise NotImplementedError("Other datasets not supported")
        nx, ny = adaptive_trans_num(xyz, init_dict["num_trans"], xy_only=True)
        xp = _axis_points(xyz[:, 0], nx, mode, init_dict["x_min"], init_dict["x_max"])
        yp = _axis_points(xyz[:, 1], ny, mode, init_dict["y_min"], init_dict["y_max"])
        gx, gy = np.meshgrid(xp, yp, indexing="ij")
        trans = np.zeros((nx * ny, 3), np.float32)
        trans[:, 0] = gx.reshape(-1)
        trans[:, 1] = gy.reshape(-1)
        if init_dict["z_prior"] is not None:
            trans[:, 2] = init_dict["z_prior"]
        else:
            trans[:, 2] = xyz[:, 2].mean()
        return trans

    nx, ny, nz = adaptive_trans_num(xyz, init_dict["num_trans"], xy_only=False)
    xp = _axis_points(xyz[:, 0], nx, mode, init_dict["x_min"], init_dict["x_max"])
    yp = _axis_points(xyz[:, 1], ny, mode, init_dict["y_min"], init_dict["y_max"])
    zp = _axis_points(xyz[:, 2], nz, mode, init_dict["z_min"], init_dict["z_max"])
    gx, gy, gz = np.meshgrid(xp, yp, zp, indexing="ij")
    return np.stack(
        [gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], axis=-1
    ).astype(np.float32)


def _rot_from_ypr_np(ypr: np.ndarray) -> np.ndarray:
    y, p, r = ypr
    cz, sz = np.cos(y), np.sin(y)
    cy, sy = np.cos(p), np.sin(p)
    cx, sx = np.cos(r), np.sin(r)
    RZ = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    RY = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    RX = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return RZ @ RY @ RX


def _cloud2idx_np(xyz: np.ndarray) -> np.ndarray:
    theta = np.arctan2(np.linalg.norm(xyz[:, :2], axis=-1), xyz[:, 2] + 1e-6)
    phi = np.arctan2(xyz[:, 1], xyz[:, 0] + 1e-6) + np.pi
    u = 2 * (1.0 - phi / (2 * np.pi)) - 1
    v = 2 * (theta / np.pi) - 1
    return np.stack([u, v], axis=-1)


def compute_sampling_grid(
    ypr: np.ndarray, num_split_h: int, num_split_w: int
) -> np.ndarray:
    """Rotation fingerprint grid (reference utils.py:719-755).

    Used only to detect rotations that produce identical low-res sampling
    grids (e.g. roll by pi at pitch 0 equals yaw offset).
    """
    R = _rot_from_ypr_np(ypr).T
    H, W = num_split_h, num_split_w
    xs = np.linspace(0, W - 1, W)
    theta = np.pi - xs * 2 * np.pi / W
    ys = np.linspace(0, H - 1, H)
    phi = ys * np.pi / H
    phi_g, theta_g = np.meshgrid(phi, theta, indexing="ij")
    a0 = theta_g - np.pi / num_split_w
    a1 = phi_g + np.pi / (num_split_h * 2)
    x = np.sin(a1) * np.cos(a0)
    y = np.sin(a1) * np.sin(a0)
    z = np.cos(a1)
    A = np.stack([x, y, z], axis=-1)  # (H, W, 3)
    B = A @ R.T  # R @ A per point
    return _cloud2idx_np(B.reshape(-1, 3)).reshape(H, W, 2)


def generate_rot_points(init_dict: Dict) -> np.ndarray:
    """(K, 3) yaw/pitch/roll starting rotations (reference utils.py:321-360).

    yaw_only: uniform yaw grid. Otherwise the full ypr meshgrid over
    [min, max) with fraction spacing i/num, filtered for duplicate
    rotations; first occurrence in grid order is kept (deterministic,
    unlike the reference's set-based dedup).
    """
    if init_dict["yaw_only"]:
        n = init_dict["num_yaw"]
        rot = np.zeros((n, 3), np.float32)
        rot[:, 0] = np.arange(n) * 2 * np.pi / n
        return rot

    ny, np_, nr = init_dict["num_yaw"], init_dict["num_pitch"], init_dict["num_roll"]
    fy = np.arange(ny) / ny
    fp = np.arange(np_) / np_
    fr = np.arange(nr) / nr
    gy, gp, gr = np.meshgrid(fy, fp, fr, indexing="ij")
    rot = np.stack([gy.reshape(-1), gp.reshape(-1), gr.reshape(-1)], axis=-1)
    rot[:, 0] = rot[:, 0] * (init_dict["max_yaw"] - init_dict["min_yaw"]) + init_dict["min_yaw"]
    rot[:, 1] = rot[:, 1] * (init_dict["max_pitch"] - init_dict["min_pitch"]) + init_dict["min_pitch"]
    rot[:, 2] = rot[:, 2] * (init_dict["max_roll"] - init_dict["min_roll"]) + init_dict["min_roll"]

    seen = set()
    keep = []
    for i, ypr in enumerate(rot):
        grid = compute_sampling_grid(
            ypr, init_dict["num_yaw"], init_dict["num_pitch"]
        )
        key = np.around(grid, 3).tobytes()
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return rot[keep].astype(np.float32)
