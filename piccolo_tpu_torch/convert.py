"""Carry the JAX package's room state across to the port.

The system has no model weights; its state is the room: the padded cloud,
the candidate grids, the slab :class:`GridPlan`, the :class:`HistPlan` and,
for tracked frames, the cloud's colour CDF and ``SharpenState``.
Given as numpy arrays (``np.asarray`` of the JAX package's arrays), they
become the port's tensors.  Both packages keep the same stream layouts, so
converting is a copy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .color import SharpenState, SharpenTensors
from .device import resolve_device
from .init.refine import HistPlan
from .kernels.slab_sampling import GridPlan

__all__ = ["grid_plan_from_numpy", "hist_plan_from_numpy", "cloud_from_numpy",
           "cdf_from_numpy", "sharpen_state_from_numpy"]


def grid_plan_from_numpy(fields: Sequence[np.ndarray],
                         windows: Sequence[np.ndarray], n_pairs: int,
                         height: int, width: int, wrap: bool, window: int,
                         block: int, tps: Sequence[np.ndarray] = (),
                         compact: bool = False, tp_is_pid: bool = False,
                         quant: bool = False, device="cuda") -> GridPlan:
    """A slab plan from per-group fields ((NB, 8, BLOCK) f32, (NB, 3, BLOCK)
    f32 compact or (NB, 1, BLOCK) int32 q8), (NB,) windows and, for
    compact and q8 plans, (NB, 1, BLOCK) f32 ``tps``."""
    dev = resolve_device(device)
    fdtype = np.int32 if quant else np.float32
    return GridPlan(
        fields=tuple(torch.tensor(np.asarray(f, fdtype), device=dev)
                     for f in fields),
        windows=tuple(torch.tensor(np.asarray(w, np.int32), device=dev)
                      for w in windows),
        n_pairs=int(n_pairs), height=int(height), width=int(width),
        wrap=bool(wrap), window=int(window), block=int(block),
        compact=bool(compact), tp_is_pid=bool(tp_is_pid), quant=bool(quant),
        tps=tuple(torch.tensor(np.asarray(t, np.float32), device=dev)
                  for t in tps),
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


def cdf_from_numpy(cdf: Tuple[np.ndarray, np.ndarray],
                   device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """A room's ``(values, quant)`` pair from ``color.cloud_color_cdf``,
    (3, K) f32 each."""
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a, np.float32), device=dev)
                 for a in cdf)


def sharpen_state_from_numpy(state: SharpenState,
                             device="cuda") -> SharpenTensors:
    """A room's ``color.SharpenState`` (the JAX package's one-hot layout) as
    the Y histogram, each point's Y level and its Cr/Cb on ``device``.  A
    pad row (zero one-hots) gets level 256, which ``color_mod_device`` maps
    to 0, as the JAX package's zero one-hot selects 0."""
    dev = resolve_device(device)
    oh_hi, oh_lo = np.asarray(state.oh_hi), np.asarray(state.oh_lo)
    y = np.where(oh_hi.any(1), oh_hi.argmax(1) * 16 + oh_lo.argmax(1), 256)
    return SharpenTensors(
        y_hist=torch.tensor(np.asarray(state.y_hist, np.float32), device=dev),
        y=torch.tensor(y.astype(np.int64), device=dev),
        crcb=torch.tensor(np.asarray(state.crcb).astype(np.int32), device=dev),
    )
