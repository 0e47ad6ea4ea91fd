"""Multi-start gradient-descent pose solver (port of piccolo_tpu.solver,
default branch).

All starts advance together: the pose leaves carry a leading start
dimension where the JAX package uses ``vmap``, and the iterations are a
Python loop where it uses ``lax.scan``.  Each start's loss depends only on
its own pose, so one ``autograd.grad`` of the summed losses gives every
start its own gradient.  The translation clamp applies to the parameters
only, after each Adam update (Adam moments are not projected).

The prune and multi-resolution speed modes are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .device import as_tensor, resolve_device
from .loss import Pose, pose_rotation, sampling_loss_packed
from .ops.sampling import (
    cast_packed_table,
    pack_bilinear_blocks,
    resolve_descent_table,
)
from .optim import adam_plateau_step, init_adam_plateau

__all__ = ["SolveResult", "descend"]


@dataclasses.dataclass
class SolveResult:
    """All starts' final states, in input order."""

    t: torch.Tensor  # (S, 3)
    ypr: torch.Tensor  # (S, 3)
    rot: torch.Tensor  # (S, 3, 3)
    loss: torch.Tensor  # (S,) loss evaluated before the last update
    lr: torch.Tensor  # (S,) final learning rates


def _make_step_for(loss_fn, lo, hi, patience, factor):
    """One loss + Adam + plateau + clamp transition from a differentiable
    per-start pose loss; returns ``step(params, state) -> (params, state,
    loss)``."""

    def step(params: Pose, state):
        leaves = [p.detach().requires_grad_(True) for p in params.leaves()]
        with torch.enable_grad():
            loss = loss_fn(Pose(*leaves))
            grads = torch.autograd.grad(loss.sum(), leaves)
        loss = loss.detach()
        params, state = adam_plateau_step(
            Pose(*[p.detach() for p in leaves]), Pose(*grads), state, loss,
            patience, factor,
        )
        params.t = torch.clamp(params.t, lo, hi)
        return params, state, loss

    return step


def _make_step(blocks, height, width, xyz, rgb, lo, hi, point_mask,
               patience, factor, wrap):
    """The step on a packed sampling table built once by the caller."""
    return _make_step_for(
        lambda p: sampling_loss_packed(
            p, xyz, rgb, blocks, height, width, point_mask, wrap=wrap
        ),
        lo, hi, patience, factor,
    )


def descend_starts(img, xyz, rgb, t0s, ypr0s, lo, hi, point_mask, num_iter,
                   lr, patience, factor, table_dtype="float32", wrap=False,
                   trajectory=False):
    """Descend (S, 3) starts for ``num_iter`` iterations.

    Returns ``(params, losses, lrs, traj)``; ``traj`` is a Pose whose
    leaves lead with (S, num_iter) when ``trajectory`` is set, else None.
    """
    H, W, _ = img.shape
    blocks = cast_packed_table(pack_bilinear_blocks(img, wrap=wrap),
                               table_dtype)
    step = _make_step(blocks, H, W, xyz, rgb, lo, hi, point_mask, patience,
                      factor, wrap)
    params = Pose(t=t0s, yaw=ypr0s[:, 0], pitch=ypr0s[:, 1],
                  roll=ypr0s[:, 2])
    state = init_adam_plateau(params, lr)
    states = []
    loss = None
    for _ in range(num_iter):
        params, state, loss = step(params, state)
        if trajectory:
            states.append(params)
    traj = None
    if trajectory:
        traj = Pose(*[torch.stack(xs, dim=1)
                      for xs in zip(*(p.leaves() for p in states))])
    return params, loss, state.lr, traj


def descend(img, xyz, rgb, trans0, ypr0, lo, hi,
            point_mask: Optional[torch.Tensor] = None, *, num_iter: int = 100,
            lr: float = 0.1, patience: int = 5, factor: float = 0.9,
            masked: bool = False, trajectory: bool = False,
            table_dtype: str = "auto", wrap: bool = False, device="cuda"):
    """Descend all candidates in parallel; returns a :class:`SolveResult`
    (and the trajectory Pose when ``trajectory``)."""
    dev = resolve_device(device)
    img = as_tensor(img, dev, torch.float32)
    xyz = as_tensor(xyz, dev, torch.float32)
    rgb = as_tensor(rgb, dev, torch.float32)
    pm = as_tensor(point_mask, dev, torch.bool) if masked else None
    H, W, _ = img.shape
    params, losses, lrs, traj = descend_starts(
        img, xyz, rgb, as_tensor(trans0, dev, torch.float32),
        as_tensor(ypr0, dev, torch.float32), as_tensor(lo, dev, torch.float32),
        as_tensor(hi, dev, torch.float32), pm, num_iter, lr, patience, factor,
        resolve_descent_table(table_dtype, H, W), wrap, trajectory,
    )
    result = SolveResult(t=params.t, ypr=params.ypr(),
                         rot=pose_rotation(params), loss=losses, lr=lrs)
    if trajectory:
        return result, traj
    return result
