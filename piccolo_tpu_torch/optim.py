"""Adam + ReduceLROnPlateau as plain state transitions (port of
piccolo_tpu.optim).

Every scalar of the state (count, lr, best, num_bad) has the params' start
shape, so each start keeps its own learning rate and plateau counter.

  * Adam: betas (0.9, 0.999), eps 1e-8 outside the sqrt, torch's exact
    factorisation p -= (lr / bc1) * m / (sqrt(v) / sqrt(bc2) + eps).
  * Plateau: 'rel' threshold 1e-4, best starts at +inf; reduce when
    num_bad > patience, applied only if the drop exceeds 1e-8.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .loss import Pose

__all__ = ["AdamPlateauState", "init_adam_plateau", "adam_plateau_step"]

_BETA1 = 0.9
_BETA2 = 0.999
_EPS = 1e-8
_THRESHOLD = 1e-4
_LR_EPS = 1e-8


@dataclasses.dataclass
class AdamPlateauState:
    m: Pose
    v: Pose
    count: torch.Tensor  # (S,) int32 Adam step count
    lr: torch.Tensor  # (S,) f32 current learning rate
    best: torch.Tensor  # (S,) f32 best loss seen by the scheduler
    num_bad: torch.Tensor  # (S,) int32 plateau counter


def _map(fn, *poses: Pose) -> Pose:
    return Pose(*[fn(*xs) for xs in zip(*(p.leaves() for p in poses))])


def _per_start(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a (S,) state scalar against a (S, ...) leaf."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def init_adam_plateau(params: Pose, lr: float) -> AdamPlateauState:
    shape, dev = params.yaw.shape, params.yaw.device
    return AdamPlateauState(
        m=_map(torch.zeros_like, params),
        v=_map(torch.zeros_like, params),
        count=torch.zeros(shape, dtype=torch.int32, device=dev),
        lr=torch.full(shape, lr, dtype=torch.float32, device=dev),
        best=torch.full(shape, float("inf"), dtype=torch.float32, device=dev),
        num_bad=torch.zeros(shape, dtype=torch.int32, device=dev),
    )


def adam_plateau_step(params: Pose, grads: Pose, state: AdamPlateauState,
                      loss: torch.Tensor, patience: int,
                      factor: float) -> Tuple[Pose, AdamPlateauState]:
    """One optimizer + scheduler transition; ``loss`` is the loss at
    ``params`` before this update."""
    count = state.count + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(_BETA1, cf)
    bc2 = 1.0 - torch.pow(_BETA2, cf)
    new_m = _map(lambda m, g: _BETA1 * m + (1 - _BETA1) * g, state.m, grads)
    new_v = _map(lambda v, g: _BETA2 * v + (1 - _BETA2) * g * g, state.v, grads)

    lr = state.lr
    step_size = lr / bc1
    sqrt_bc2 = torch.sqrt(bc2)

    def upd(p, m, v):
        return p - _per_start(step_size, p) * m / (
            torch.sqrt(v) / _per_start(sqrt_bc2, p) + _EPS
        )

    new_params = _map(upd, params, new_m, new_v)

    is_better = loss < state.best * (1.0 - _THRESHOLD)
    best = torch.where(is_better, loss, state.best)
    num_bad = torch.where(is_better, torch.zeros_like(state.num_bad),
                          state.num_bad + 1)
    reduce = num_bad > patience
    cand_lr = lr * factor
    new_lr = torch.where(reduce & (lr - cand_lr > _LR_EPS), cand_lr, lr)
    num_bad = torch.where(reduce, torch.zeros_like(num_bad), num_bad)
    return new_params, AdamPlateauState(
        m=new_m, v=new_v, count=count, lr=new_lr, best=best, num_bad=num_bad
    )
