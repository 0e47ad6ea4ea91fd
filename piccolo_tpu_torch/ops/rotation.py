"""Rotation construction from yaw/pitch/roll (port of piccolo_tpu.ops.rotation).

Convention: R = RZ(yaw) @ RY(pitch) @ RX(roll), applied to points as
``x_cam = R @ (x_world - t)``.  Rank-polymorphic: (..., 3) ypr -> (..., 3, 3).

The 3x3 products are written as elementwise multiply-adds, so they run in
full f32 whatever the TF32 flags say (the JAX package forces
``precision="highest"`` for the same reason).
"""

from __future__ import annotations

import torch

__all__ = ["rot_from_ypr", "rot_x", "rot_y", "rot_z", "matmul33"]


def _stack_rows(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_x(a: torch.Tensor) -> torch.Tensor:
    """(...,) angle -> (..., 3, 3) rotation about +x (roll)."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack_rows([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(a: torch.Tensor) -> torch.Tensor:
    """(...,) angle -> (..., 3, 3) rotation about +y (pitch)."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack_rows([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(a: torch.Tensor) -> torch.Tensor:
    """(...,) angle -> (..., 3, 3) rotation about +z (yaw)."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack_rows([[c, -s, z], [s, c, z], [z, z, o]])


def matmul33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as f32 multiply-adds, summed j = 0, 1, 2."""
    return (
        a[..., :, 0:1] * b[..., 0:1, :]
        + a[..., :, 1:2] * b[..., 1:2, :]
        + a[..., :, 2:3] * b[..., 2:3, :]
    )


def rot_from_ypr(ypr: torch.Tensor) -> torch.Tensor:
    """(..., 3) [yaw, pitch, roll] -> (..., 3, 3) R = RZ @ RY @ RX."""
    return matmul33(
        matmul33(rot_z(ypr[..., 0]), rot_y(ypr[..., 1])), rot_x(ypr[..., 2])
    )
