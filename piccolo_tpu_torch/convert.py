"""Carry the JAX package's room state across to the port.

The system has no model weights; its state is the room: the padded cloud,
the candidate grids, the slab :class:`GridPlan` and the :class:`HistPlan`.
Given as numpy arrays (``np.asarray`` of the JAX package's arrays), they
become the port's tensors.  Both packages keep the same stream layouts, so
converting is a copy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .init.refine import HistPlan
from .kernels.slab_sampling import GridPlan

__all__ = ["grid_plan_from_numpy", "hist_plan_from_numpy", "cloud_from_numpy"]


def grid_plan_from_numpy(fields: Sequence[np.ndarray],
                         windows: Sequence[np.ndarray], n_pairs: int,
                         height: int, width: int, wrap: bool, window: int,
                         block: int, device="cuda") -> GridPlan:
    """An f32 slab plan from per-group (NB, 8, BLOCK) fields and (NB,)
    windows."""
    dev = resolve_device(device)
    return GridPlan(
        fields=tuple(torch.tensor(np.asarray(f, np.float32), device=dev)
                     for f in fields),
        windows=tuple(torch.tensor(np.asarray(w, np.int32), device=dev)
                      for w in windows),
        n_pairs=int(n_pairs), height=int(height), width=int(width),
        wrap=bool(wrap), window=int(window), block=int(block),
    )


def hist_plan_from_numpy(planes: np.ndarray, n_pairs: int, height: int,
                         width: int, device="cuda") -> HistPlan:
    """Winner-bin planes, (n_pairs, H*W) int16."""
    dev = resolve_device(device)
    return HistPlan(torch.tensor(np.asarray(planes, np.int16), device=dev),
                    int(n_pairs), int(height), int(width))


def cloud_from_numpy(xyz: np.ndarray, rgb: np.ndarray, mask: np.ndarray,
                     device="cuda") -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(xyz f32, rgb f32, mask bool) tensors of a padded cloud."""
    dev = resolve_device(device)
    return (torch.tensor(np.asarray(xyz, np.float32), device=dev),
            torch.tensor(np.asarray(rgb, np.float32), device=dev),
            torch.tensor(np.asarray(mask, bool), device=dev))
