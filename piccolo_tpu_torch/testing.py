"""Synthetic scenes (port of piccolo_tpu.testing's room factory).

Render a panorama from a synthetic coloured cloud at a known pose, then
require the pipeline to recover that pose.  ``make_room`` and
``random_pose_inside`` are numpy and draw exactly the JAX package's numbers
from the same generator.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .device import as_tensor, resolve_device
from .loss import Pose, transform_cloud
from .ops.pano import render_pano

__all__ = ["make_room", "random_pose_inside", "render_at"]

_WALL_FACES = ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1))


def _wall_color(u, v, axis: int, sign: int, texture: str) -> np.ndarray:
    """Wall texture as a function of normalised surface coords."""
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    base = np.zeros(3, np.float32)
    base[axis] = 0.75 if sign > 0 else 0.25
    c = base + 0.5 * np.stack([u, v, u * v], -1)
    if texture == "checker":
        checker = ((u * 6).astype(int) + (v * 6).astype(int)) % 2
        c = c * (0.6 + 0.4 * checker[..., None])
    return np.clip(c, 0.05, 1.0).astype(np.float32)


def make_room(rng: np.random.Generator, n_per_wall: int = 4000,
              size: Tuple[float, float, float] = (6.0, 4.0, 3.0),
              texture: str = "gradient") -> Tuple[np.ndarray, np.ndarray]:
    """A coloured box room: (xyz (6*n_per_wall, 3), rgb in [0, 1]) f32."""
    pts, cols = [], []
    for axis, sign in _WALL_FACES:
        uv = rng.random((n_per_wall, 2)).astype(np.float32)
        p = np.empty((n_per_wall, 3), np.float32)
        dims = [d for d in range(3) if d != axis]
        p[:, dims[0]] = (uv[:, 0] - 0.5) * size[dims[0]]
        p[:, dims[1]] = (uv[:, 1] - 0.5) * size[dims[1]]
        p[:, axis] = sign * size[axis] / 2
        pts.append(p)
        cols.append(_wall_color(uv[:, 0], uv[:, 1], axis, sign, texture))
    return np.concatenate(pts), np.concatenate(cols)


def random_pose_inside(rng: np.random.Generator,
                       size: Tuple[float, float, float] = (6.0, 4.0, 3.0),
                       margin: float = 0.35,
                       yaw_only: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """A random pose well inside the room's quantile box."""
    half = np.array(size, np.float32) / 2
    lo = -half * (1 - margin)
    hi = half * (1 - margin)
    t = (rng.random(3).astype(np.float32) * (hi - lo) + lo).astype(np.float32)
    yaw = rng.random() * 2 * np.pi
    if yaw_only:
        ypr = np.array([yaw, 0.0, 0.0], np.float32)
    else:
        ypr = np.array(
            [yaw, (rng.random() - 0.5) * 0.3, (rng.random() - 0.5) * 0.3],
            np.float32,
        )
    return t, ypr


def render_at(xyz, rgb, t, ypr, resolution: Tuple[int, int] = (256, 512),
              device="cuda") -> torch.Tensor:
    """The ground-truth panorama at pose (t, ypr): (H, W, 3) in [0, 1] on
    ``device``."""
    dev = resolve_device(device)
    t = as_tensor(t, dev, torch.float32)
    ypr = as_tensor(ypr, dev, torch.float32)
    cam = transform_cloud(Pose(t=t, yaw=ypr[0], pitch=ypr[1], roll=ypr[2]),
                          as_tensor(xyz, dev, torch.float32))
    return render_pano(cam, as_tensor(rgb, dev, torch.float32),
                       resolution) / 255.0
