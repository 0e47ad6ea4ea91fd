"""Full-image warping through the bilinear sampler (port of
piccolo_tpu/ops/warp.py; the reference's ``warp_from_img``,
``utils.py:106-131``)."""

from __future__ import annotations

import torch

from .sampling import bilinear_sample

__all__ = ["warp_from_img"]


def warp_from_img(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Warp ``img`` by a coordinate ``grid``.

    Args:
      img:  (H, W, C) source image.
      grid: (H', W', 2) normalized (x, y) sampling coordinates in [-1, 1].

    Returns:
      (H', W', C) warped image, with :func:`bilinear_sample`'s semantics
      (zeros outside, coordinates clipped to +-0.99, align_corners=False).
    """
    Ho, Wo, _ = grid.shape
    out = bilinear_sample(img, grid.reshape(-1, 2))
    return out.reshape(Ho, Wo, img.shape[-1])
