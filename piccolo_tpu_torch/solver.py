"""Multi-start gradient-descent pose solver (port of piccolo_tpu.solver).

All starts advance together: the pose leaves carry a leading start
dimension where the JAX package uses ``vmap``, and the iterations are a
Python loop where it uses ``lax.scan``.  Each start's loss depends only on
its own pose, so one ``autograd.grad`` of the summed losses gives every
start its own gradient.  The translation clamp applies to the parameters
only, after each Adam update (Adam moments are not projected).

Two opt-in speed modes have no reference counterpart: the pruned descent
(every start for ``prune_iter`` iterations, then only the ``prune_keep``
best finish the budget) and the multi-resolution descent (the first
``low_iters`` iterations on a stride-downsampled table).  Both carry the
Adam and plateau state exactly across their split.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .device import as_tensor, resolve_device
from .loss import Pose, pose_rotation, sampling_loss, sampling_loss_packed
from .ops.rotation import rot_from_ypr
from .ops.sampling import (
    cast_packed_table,
    pack_bilinear_blocks,
    resolve_descent_table,
)
from .optim import AdamPlateauState, adam_plateau_step, init_adam_plateau

__all__ = ["SolveResult", "descend", "evaluate_poses", "solve"]


@dataclasses.dataclass
class SolveResult:
    """All starts' final states, in input order."""

    t: torch.Tensor  # (S, 3)
    ypr: torch.Tensor  # (S, 3)
    rot: torch.Tensor  # (S, 3, 3)
    loss: torch.Tensor  # (S,) loss evaluated before the last update
    lr: torch.Tensor  # (S,) final learning rates


def _check_prune(prune, num_iter: int, n_cand: int, trajectory: bool):
    """``(prune_iter, prune_keep)``, or None when pruning saves nothing (off,
    keeping every start, or no iteration after the split); raises on
    nonsensical combinations."""
    if prune is None:
        return None
    k, m = int(prune[0]), int(prune[1])
    if k <= 0 or m >= n_cand or k >= num_iter:
        return None
    if m < 1:
        raise ValueError(f"descent prune must keep >= 1 candidate, got {m}")
    if trajectory:
        raise ValueError(
            "trajectory=True is incompatible with descent pruning (pruned "
            "candidates have no post-prune states to visualize) — disable "
            "one of the two"
        )
    return (k, m)


def _check_multires(multires, num_iter: int, prune, trajectory: bool):
    """``(low_iters, stride)``, or None when there are no low-resolution
    iterations; raises on nonsensical combinations."""
    if multires is None:
        return None
    k, s = int(multires[0]), int(multires[1])
    if k <= 0:
        return None
    if s < 2:
        raise ValueError(f"multires stride must be >= 2, got {s}")
    if k >= num_iter:
        raise ValueError(
            f"multires low-res iterations ({k}) must leave full-res "
            f"refinement iterations (num_iter={num_iter})"
        )
    if prune is not None:
        raise ValueError(
            "descent multires and descent prune cannot combine (the prune "
            "split and the resolution split would need a shared schedule) "
            "— enable one of the two"
        )
    if trajectory:
        raise ValueError(
            "trajectory=True is incompatible with multires descent (the "
            "per-iteration losses change scale at the resolution switch, "
            "so the frames would not be comparable) — disable one"
        )
    return (k, s)


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


def _packed_table(img, table_dtype: str, wrap: bool):
    return cast_packed_table(pack_bilinear_blocks(img, wrap=wrap), table_dtype)


def _run(step, params, state, n: int, trajectory: bool = False):
    """``n`` steps; returns (params, state, last loss, per-step params)."""
    loss, states = None, []
    for _ in range(n):
        params, state, loss = step(params, state)
        if trajectory:
            states.append(params)
    return params, state, loss, states


def _take(tree, idx: torch.Tensor):
    """Rows ``idx`` of every start-leading leaf of a Pose or optimizer
    state."""
    if isinstance(tree, Pose):
        return Pose(*[x[idx] for x in tree.leaves()])
    return AdamPlateauState(
        m=_take(tree.m, idx), v=_take(tree.v, idx), count=tree.count[idx],
        lr=tree.lr[idx], best=tree.best[idx], num_bad=tree.num_bad[idx])


def _descend_pruned(blocks, height, width, xyz, rgb, params, state, lo, hi,
                    point_mask, num_iter, patience, factor, wrap,
                    prune_iter: int, prune_keep: int, start_valid=None):
    """Every start for ``prune_iter`` steps, then the ``prune_keep``
    lowest-loss survivors finish the budget with their whole optimizer state
    (moments, step count, learning rate, plateau best and counter).  Results
    come back in input order; pruned rows report their phase-1 state.

    One stable argsort gives disjoint survivor and pruned sets even on ties;
    ``start_valid`` False rows (clones of the best start) rank +inf, so a
    clone's identical phase-1 loss never takes a survivor slot."""
    step = _make_step(blocks, height, width, xyz, rgb, lo, hi, point_mask,
                      patience, factor, wrap)
    params1, state1, loss1, _ = _run(step, params, state, prune_iter)
    rank = loss1
    if start_valid is not None:
        rank = torch.where(start_valid, loss1, torch.full_like(loss1, math.inf))
    order = torch.argsort(rank, stable=True)
    keep, drop = order[:prune_keep], order[prune_keep:]
    params2, state2, loss2, _ = _run(step, _take(params1, keep),
                                     _take(state1, keep),
                                     num_iter - prune_iter)
    inv = torch.argsort(order)
    dropped = _take(params1, drop)
    params = Pose(*[torch.cat([a, b])[inv]
                    for a, b in zip(params2.leaves(), dropped.leaves())])
    losses = torch.cat([loss2, loss1[drop]])[inv]
    lrs = torch.cat([state2.lr, state1.lr[drop]])[inv]
    return params, losses, lrs


def descend_starts(img, xyz, rgb, t0s, ypr0s, lo, hi, point_mask, num_iter,
                   lr, patience, factor, table_dtype="float32", wrap=False,
                   trajectory=False, prune=None, multires=None,
                   table_arg="auto", start_valid=None):
    """Descend (S, 3) starts for ``num_iter`` iterations on (H, W, 3)
    ``img``, with its packed table in ``table_dtype``.

    ``prune``/``multires`` select the speed modes (validated here; the
    multi-resolution table resolves its own dtype from ``table_arg``).
    Returns ``(params, losses, lrs, traj)``; ``traj`` is a Pose whose leaves
    lead with (S, num_iter) when ``trajectory`` is set, else None."""
    H, W, _ = img.shape
    blocks = _packed_table(img, table_dtype, wrap)
    prune = _check_prune(prune, num_iter, t0s.shape[0], trajectory)
    multires = _check_multires(multires, num_iter, prune, trajectory)
    params = Pose(t=t0s, yaw=ypr0s[:, 0], pitch=ypr0s[:, 1],
                  roll=ypr0s[:, 2])
    state = init_adam_plateau(params, lr)
    if prune is not None:
        params, losses, lrs = _descend_pruned(
            blocks, H, W, xyz, rgb, params, state, lo, hi, point_mask,
            num_iter, patience, factor, wrap, prune[0], prune[1],
            start_valid=start_valid,
        )
        return params, losses, lrs, None
    step = _make_step(blocks, H, W, xyz, rgb, lo, hi, point_mask, patience,
                      factor, wrap)
    n_full = num_iter
    if multires is not None:
        # the first k_low iterations on img[::s, ::s], whose table resolves
        # its own dtype (a small table stays f32 under auto); the final
        # loss is a full-resolution one
        k_low, s = multires
        img_lo = img[::s, ::s].contiguous()
        h_lo, w_lo = int(img_lo.shape[0]), int(img_lo.shape[1])
        blocks_lo = _packed_table(
            img_lo, resolve_descent_table(table_arg, h_lo, w_lo), wrap)
        step_lo = _make_step(blocks_lo, h_lo, w_lo, xyz, rgb, lo, hi,
                             point_mask, patience, factor, wrap)
        params, state, _, _ = _run(step_lo, params, state, k_low)
        n_full = num_iter - k_low
    params, state, loss, states = _run(step, params, state, n_full,
                                       trajectory)
    traj = None
    if trajectory:
        traj = Pose(*[torch.stack(xs, dim=1)
                      for xs in zip(*(p.leaves() for p in states))])
    return params, loss, state.lr, traj


def descend(img, xyz, rgb, trans0, ypr0, lo, hi,
            point_mask: Optional[torch.Tensor] = None, *, num_iter: int = 100,
            lr: float = 0.1, patience: int = 5, factor: float = 0.9,
            masked: bool = False, trajectory: bool = False,
            table_dtype: str = "auto", wrap: bool = False,
            prune: Optional[Tuple[int, int]] = None,
            multires: Optional[Tuple[int, int]] = None,
            start_valid=None, device="cuda"):
    """Descend all candidates in parallel; returns a :class:`SolveResult`
    (and the trajectory Pose when ``trajectory``).

    ``prune=(prune_iter, prune_keep)``: after ``prune_iter`` steps only the
    ``prune_keep`` lowest-loss candidates finish the budget; pruned rows
    report their frozen phase-1 state.  ``multires=(low_iters, stride)``:
    the first ``low_iters`` iterations sample a stride-downsampled table.
    Both are off by default (the reference descends every start at one
    resolution), and neither combines with the other or with
    ``trajectory``.  ``start_valid`` (S,) bool marks clone rows False so
    they never take a survivor slot."""
    dev = resolve_device(device)
    img = as_tensor(img, dev, torch.float32)
    xyz = as_tensor(xyz, dev, torch.float32)
    rgb = as_tensor(rgb, dev, torch.float32)
    pm = as_tensor(point_mask, dev, torch.bool) if masked else None
    sv = None if start_valid is None else as_tensor(start_valid, dev,
                                                    torch.bool)
    H, W, _ = img.shape
    params, losses, lrs, traj = descend_starts(
        img, xyz, rgb, as_tensor(trans0, dev, torch.float32),
        as_tensor(ypr0, dev, torch.float32), as_tensor(lo, dev, torch.float32),
        as_tensor(hi, dev, torch.float32), pm, num_iter, lr, patience, factor,
        resolve_descent_table(table_dtype, H, W), wrap, trajectory,
        prune=prune, multires=multires, table_arg=table_dtype,
        start_valid=sv,
    )
    result = SolveResult(t=params.t, ypr=params.ypr(),
                         rot=pose_rotation(params), loss=losses, lr=lrs)
    if trajectory:
        return result, traj
    return result


def evaluate_poses(img, xyz, rgb, trans, ypr, point_mask=None, *,
                   masked: bool = False, device="cuda"):
    """One-shot loss of candidate poses on the unpacked sampling loss (no
    descent); returns (losses (B,), rotations (B, 3, 3))."""
    dev = resolve_device(device)
    ypr = as_tensor(ypr, dev, torch.float32)
    pose = Pose(t=as_tensor(trans, dev, torch.float32), yaw=ypr[:, 0],
                pitch=ypr[:, 1], roll=ypr[:, 2])
    pm = as_tensor(point_mask, dev, torch.bool) if masked else None
    losses = sampling_loss(pose, as_tensor(xyz, dev, torch.float32),
                           as_tensor(rgb, dev, torch.float32),
                           as_tensor(img, dev, torch.float32), pm)
    return losses, rot_from_ypr(ypr)


def solve(img, xyz, rgb, trans0, ypr0, lo, hi, point_mask=None, **kw):
    """Run :func:`descend` and select the minimum-loss candidate (the first
    among equal losses); returns (t (3,), R (3, 3), loss (), SolveResult)."""
    res = descend(img, xyz, rgb, trans0, ypr0, lo, hi, point_mask,
                  masked=point_mask is not None, **kw)
    k = torch.argmin(res.loss)
    return res.t[k], res.rot[k], res.loss[k], res
