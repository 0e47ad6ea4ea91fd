"""Spherical (equirectangular) projection (port of piccolo_tpu.ops.projection).

  theta = atan2(||xy||, z + 1e-6) in [0, pi]
  phi   = atan2(y, x + 1e-6) + pi in [0, 2 pi]
  u = 2 (1 - phi / 2pi) - 1,  v = 2 theta / pi - 1
"""

from __future__ import annotations

import math

import torch

__all__ = ["spherical_project", "safe_norm", "sum_sq"]

_TWO_PI = 2.0 * math.pi


def sum_sq(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, channels added left to right."""
    out = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        out = out + x[..., c] * x[..., c]
    return out


def safe_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis with a zero (not NaN) gradient at the
    origin: the double where keeps sqrt's backward away from 0."""
    sq = sum_sq(x)
    pos = sq > 0
    return torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))) * pos


def spherical_project(xyz: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) (u, v) coords in [-1, 1]."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    theta = torch.atan2(safe_norm(xyz[..., :2]), z + 1e-6)
    phi = torch.atan2(y, x + 1e-6) + math.pi
    u = 2.0 * (1.0 - phi / _TWO_PI) - 1.0
    v = 2.0 * (theta / math.pi) - 1.0
    return torch.stack([u, v], dim=-1)
