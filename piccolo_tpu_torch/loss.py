"""The PICCOLO sampling loss (port of piccolo_tpu.loss).

  * x_cam = R(yaw, pitch, roll) @ (x_world - t)
  * project to equirect coords, bilinear-sample the image
  * drop points whose sampled RGB is exactly (0, 0, 0)
  * loss = mean over the kept points of ||sampled - point_rgb||_2

A ``Pose`` may carry leading start dimensions (t (S, 3), angles (S,)): the
loss then has shape (S,), one independent value per start, which is how
the port writes out the JAX package's ``vmap`` over starts.  A stack of R
clouds ((R, N, 3), colours (R, N, 3), mask (R, N)) takes poses with leading
(R, S) dimensions: room r's S starts score against cloud r, the JAX
package's ``vmap`` over rooms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .ops.projection import safe_norm, spherical_project
from .ops.rotation import rot_from_ypr
from .ops.sampling import bilinear_sample, bilinear_sample_packed

__all__ = [
    "Pose",
    "pose_rotation",
    "sampling_loss",
    "sampling_loss_packed",
    "sampling_partials_packed",
    "masked_mean",
    "transform_cloud",
]


@dataclasses.dataclass
class Pose:
    """6-DoF pose: translation plus yaw/pitch/roll, R = RZ @ RY @ RX."""

    t: torch.Tensor  # (..., 3)
    yaw: torch.Tensor  # (...)
    pitch: torch.Tensor
    roll: torch.Tensor

    def leaves(self):
        return (self.t, self.yaw, self.pitch, self.roll)

    def ypr(self) -> torch.Tensor:
        return torch.stack([self.yaw, self.pitch, self.roll], dim=-1)


def pose_rotation(pose: Pose) -> torch.Tensor:
    """(..., 3, 3) rotation matrix of a pose."""
    return rot_from_ypr(pose.ypr())


def _per_room(x: torch.Tensor, dims: int) -> torch.Tensor:
    """A per-room stack ((R, N) + ``dims`` trailing axes) gets a start axis
    after R; a single cloud passes through."""
    return x.unsqueeze(-2 - dims) if x.dim() == 2 + dims else x


def transform_cloud(pose: Pose, xyz: torch.Tensor) -> torch.Tensor:
    """World points (N, 3) -> camera frame (..., N, 3): R @ (x - t).  A stack
    of clouds (R, N, 3) takes poses of leading (R, S) and gives (R, S, N, 3).

    Elementwise multiply-adds (summed j = 0, 1, 2): full f32 whatever the
    TF32 flags say."""
    R = pose_rotation(pose)
    c = _per_room(xyz, 1) - pose.t[..., None, :]
    return (
        c[..., 0:1] * R[..., None, :, 0]
        + c[..., 1:2] * R[..., None, :, 1]
        + c[..., 2:3] * R[..., None, :, 2]
    )


def sampling_loss(pose: Pose, xyz: torch.Tensor, rgb: torch.Tensor,
                  img: torch.Tensor, point_mask: Optional[torch.Tensor] = None,
                  wrap: bool = False) -> torch.Tensor:
    """Mean masked colour distance of ``pose`` against (H, W, 3) ``img``."""
    coords = spherical_project(transform_cloud(pose, xyz))
    sampled = bilinear_sample(img, coords, wrap=wrap)
    return _masked_color_loss(sampled, rgb, point_mask)


def sampling_loss_packed(pose: Pose, xyz: torch.Tensor, rgb: torch.Tensor,
                         blocks: torch.Tensor, height: int, width: int,
                         point_mask: Optional[torch.Tensor] = None,
                         wrap: bool = False,
                         row_offset: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """:func:`sampling_loss` on a packed-neighbourhood table (one gather per
    point); ``row_offset`` picks each start's table from a stack
    (``bilinear_sample_packed``)."""
    coords = spherical_project(transform_cloud(pose, xyz))
    sampled = bilinear_sample_packed(blocks, height, width, coords, wrap=wrap,
                                     row_offset=row_offset)
    return _masked_color_loss(sampled, rgb, point_mask)


def sampling_partials_packed(pose: Pose, xyz: torch.Tensor, rgb: torch.Tensor,
                             blocks: torch.Tensor, height: int, width: int,
                             point_mask: Optional[torch.Tensor] = None,
                             wrap: bool = False):
    """The two sums behind :func:`sampling_loss_packed`: the colour
    distances' total and the valid count (int64) over this cloud's points.
    A cloud split into shards gives the whole cloud's loss from its shards'
    sums (``parallel``)."""
    coords = spherical_project(transform_cloud(pose, xyz))
    sampled = bilinear_sample_packed(blocks, height, width, coords, wrap=wrap)
    return _masked_color_partials(sampled, rgb, point_mask)


def _masked_color_partials(sampled, rgb, point_mask):
    # pure-black samples are dropped (reference omniloc.py:198)
    valid = (sampled == 0.0).sum(-1) != 3
    if point_mask is not None:
        valid = valid & _per_room(point_mask, 0)
    per_point = safe_norm(sampled - _per_room(rgb, 1))
    return (per_point * valid).sum(-1), valid.sum(-1)


def masked_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The loss from its sums: ``total / count``, and +inf where a pose
    samples nothing (ranking discards it; the where keeps its gradient
    finite)."""
    mean = total / count.clamp_min(1)
    return torch.where(count > 0, mean, torch.full_like(mean, float("inf")))


def _masked_color_loss(sampled, rgb, point_mask):
    return masked_mean(*_masked_color_partials(sampled, rgb, point_mask))
