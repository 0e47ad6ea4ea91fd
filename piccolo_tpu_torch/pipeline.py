"""The fused per-query localization (port of piccolo_tpu.pipeline):

    loss table over the trans x rot grid (slab kernel or gather engine)
      -> top num_intermediate (stable)
      -> per-candidate histogram trim (block-histogram kernel)
      -> top num_input (stable)
      -> multi-start Adam/plateau descent
      -> winner argmin

Selections use ``torch.sort(stable=True)``: ``lax.top_k`` keeps the lower
index first among ties, ``torch.topk`` promises no order, and ties are
common here (every padding pair scores +inf).

Each stage runs inside a span (``utils.profiling.span``:
``localize.stage1_*``, ``localize.stage2_*``, ``localize.stage3_*``) so a
profile of a query charges device time to its stage; ``chip_smoke.py`` and
the benchmark's traced runs read them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .device import as_tensor, resolve_device
from .init.refine import (
    HistPlan,
    _score_pairs,
    check_criterion,
    gather_chunk,
    hist_scores_core,
    hist_scores_from_planes,
)
from .kernels.slab_sampling import GridPlan, make_pairs, slab_pair_scores
from .ops.rotation import rot_from_ypr
from .ops.sampling import resolve_descent_table
from .solver import descend_starts
from .utils.profiling import span

__all__ = ["LocalizeResult", "localize_query", "localize_query_batch"]


@dataclasses.dataclass
class LocalizeResult:
    t: torch.Tensor  # (3,) winner translation
    rot: torch.Tensor  # (3, 3) winner rotation
    loss: torch.Tensor  # () winner loss
    cand_t: torch.Tensor  # (num_input, 3) final candidate translations
    cand_ypr: torch.Tensor  # (num_input, 3)
    cand_loss: torch.Tensor  # (num_input,)
    start_t: torch.Tensor  # (num_input, 3) selected starting translations
    start_ypr: torch.Tensor  # (num_input, 3)
    winner: torch.Tensor  # () index into the candidates


def _grid_scores(img, xyz, rgb, pair_t, pair_ypr, pair_valid, point_mask,
                 chunk, wrap=False):
    """Loss table over (trans, rot) pairs with the gather engine; invalid
    pairs score +inf."""
    s = _score_pairs(img, xyz, rgb, pair_t, pair_ypr, point_mask, chunk, wrap)
    return torch.where(pair_valid, s, torch.full_like(s, math.inf))


def _check_plans(plan, hist_plan, img_init, T, R, seam_wrap,
                 plan_refresh_rgb):
    if plan is not None and plan.wrap != seam_wrap:
        raise ValueError(
            f"plan was built with wrap={plan.wrap} but seam_wrap="
            f"{seam_wrap} — its table rows assume the other seam mode"
        )
    if plan is not None and (plan.n_pairs > T * R or plan.n_pairs % R):
        raise ValueError(
            f"plan covers {plan.n_pairs} candidate pairs but the grids "
            f"imply {T} trans x {R} rots = {T * R} — the plan was built "
            "for different grids (rebuild it for this room/config)"
        )
    if hist_plan is not None:
        if (hist_plan.height, hist_plan.width) != tuple(img_init.shape[:2]):
            raise ValueError(
                f"hist_plan was built for a {hist_plan.height}x"
                f"{hist_plan.width} init image but the query image is "
                f"{tuple(img_init.shape[:2])}"
            )
        if hist_plan.n_pairs > T * R or hist_plan.n_pairs % R:
            raise ValueError(
                f"hist_plan covers {hist_plan.n_pairs} pairs but the grids "
                f"imply {T}x{R}={T * R} (stale plan? rebuild for these "
                "grids)"
            )
        if plan_refresh_rgb:
            raise ValueError(
                "hist_plan bakes point colour bins at build time — a "
                "per-query rgb rebind (plan_refresh_rgb) invalidates it; "
                "pass hist_plan=None for colour-rebinding queries"
            )


def localize_query(
    img_init,
    img_main,
    xyz,
    rgb,
    trans_grid,  # (T, 3) padded candidate translations
    rot_grid,  # (R, 3) rotation grid
    trans_valid,  # (T,) bool, False for padding rows
    lo,
    hi,
    point_mask=None,
    *,
    num_intermediate: int = 20,
    num_input: int = 6,
    num_split_h: int = 4,
    num_split_w: int = 4,
    num_iter: int = 100,
    lr: float = 0.1,
    patience: int = 5,
    factor: float = 0.9,
    masked: bool = False,
    grid_chunk: Optional[int] = None,
    hist_chunk: int = 4,
    plan: Optional[GridPlan] = None,
    plan_refresh_rgb: bool = False,
    hist_plan: Optional[HistPlan] = None,
    descent_table: str = "auto",
    seam_wrap: bool = False,
    trajectory: bool = False,
    criterion: str = "loss_histogram",
    descent_prune: Optional[Tuple[int, int]] = None,
    plan_tail: str = "pad",
    descent_multires: Optional[Tuple[int, int]] = None,
    device="cuda",
    _eager: bool = False,
):
    """Localize one panorama; returns a :class:`LocalizeResult`, or
    ``(result, traj)`` with ``trajectory=True`` (``traj`` a Pose whose
    leaves lead with (num_input, num_iter)).

    Arguments follow the JAX package's ``localize_query``:

    ``plan`` scores stage 1 with the slab kernel; pairs beyond
    ``plan.n_pairs`` are grid padding (``plan_tail="pad"``, +inf) or real
    pairs of a partial plan scored by the gather engine
    (``plan_tail="xla"``).  ``plan_refresh_rgb`` re-bakes the plan's
    targets from ``rgb``.  ``hist_plan`` replaces stage 2's live splat by
    precomputed winner-bin planes.  ``criterion="loss"`` skips stage 2.
    ``descent_table`` picks the descent table's texel dtype (``auto``,
    ``float32``, ``bfloat16``, ``uint8``); ``seam_wrap`` samples across the
    equirect seam; ``grid_chunk``/``hist_chunk`` bound how many poses the
    gather engine and the live splat process at once (``grid_chunk=None``:
    ``init.refine.gather_chunk`` of the cloud and device).

    ``descent_prune=(prune_iter, prune_keep)`` and
    ``descent_multires=(low_iters, stride)`` are the descent's speed modes
    (``solver.descend``); both are off by default, and neither combines
    with the other or with ``trajectory``.  Clone rows of the scarce-pair
    fallback never take a prune survivor slot.  On the card the descent
    replays its captured step (``solver``); ``_eager=True`` runs it as the
    eager loop instead, the reference the graph is held against.
    """
    check_criterion(criterion)
    if plan_tail not in ("pad", "xla"):
        raise ValueError(f"plan_tail must be 'pad' or 'xla', got {plan_tail!r}")
    dev = resolve_device(device)
    f32 = torch.float32
    img_init = as_tensor(img_init, dev, f32)
    img_main = as_tensor(img_main, dev, f32)
    xyz = as_tensor(xyz, dev, f32)
    rgb = as_tensor(rgb, dev, f32)
    trans_grid = as_tensor(trans_grid, dev, f32)
    rot_grid = as_tensor(rot_grid, dev, f32)
    trans_valid = as_tensor(trans_valid, dev, torch.bool)
    lo = as_tensor(lo, dev, f32)
    hi = as_tensor(hi, dev, f32)
    pm = as_tensor(point_mask, dev, torch.bool) if masked else None
    table_dtype = resolve_descent_table(descent_table, img_main.shape[0],
                                        img_main.shape[1], dev)
    T, R = trans_grid.shape[0], rot_grid.shape[0]
    _check_plans(plan, hist_plan, img_init, T, R, seam_wrap, plan_refresh_rgb)
    if grid_chunk is None:
        grid_chunk = gather_chunk(xyz.shape[0], dev)

    # ---- stage 1: loss table over the candidate grid
    with span("localize.stage1_loss_table"):
        pair_t, pair_r = make_pairs(trans_grid, rot_grid)
        pair_valid = torch.repeat_interleave(trans_valid, R)
        if plan is not None:
            scores = slab_pair_scores(img_init, plan,
                                      rgb if plan_refresh_rgb else None)
            n = plan.n_pairs
            if n < T * R:
                if plan_tail == "xla":
                    tail = _grid_scores(img_init, xyz, rgb, pair_t[n:],
                                        pair_r[n:], pair_valid[n:], pm,
                                        grid_chunk, wrap=seam_wrap)
                else:
                    tail = torch.full((T * R - n,), math.inf, device=dev)
                scores = torch.cat([scores, tail])
            scores = torch.where(pair_valid, scores,
                                 torch.full_like(scores, math.inf))
        else:
            scores = _grid_scores(img_init, xyz, rgb, pair_t, pair_r,
                                  pair_valid, pm, grid_chunk, wrap=seam_wrap)
        k1 = min(num_intermediate if criterion == "loss_histogram"
                 else num_input, T * R)
        top1 = torch.sort(scores, stable=True)
        idx1 = top1.indices[:k1]
        # fewer valid pairs than k1: +inf rows slip in; stage 2 must never
        # promote them
        sel_valid = torch.isfinite(top1.values[:k1])
        t1, r1 = pair_t[idx1], pair_r[idx1]

    if criterion == "loss":
        t2, r2, final_valid = t1, r1, sel_valid
    else:
        # ---- stage 2: histogram trim
        with span("localize.stage2_hist_trim"):
            if hist_plan is not None:
                sel = hist_plan.planes[idx1.clamp_max(hist_plan.n_pairs - 1)]
                hs = hist_scores_from_planes(img_init, sel, num_split_h,
                                             num_split_w)
            else:
                hs = hist_scores_core(img_init, xyz, rgb, t1, r1, pm,
                                      num_split_h, num_split_w, hist_chunk)
            hs = torch.where(sel_valid, hs, torch.full_like(hs, -math.inf))
            k2 = min(num_input, k1)
            idx2 = torch.sort(-hs, stable=True).indices[:k2]
            t2, r2 = t1[idx2], r1[idx2]
            final_valid = sel_valid[idx2]
    # fewer valid pairs than starts: clone the best valid start into the
    # trailing slots instead of descending from padding poses
    t2 = torch.where(final_valid[:, None], t2, t2[0])
    r2 = torch.where(final_valid[:, None], r2, r2[0])

    # ---- stage 3: multi-start descent
    with span("localize.stage3_descent"):
        params, losses, _, traj = descend_starts(
            img_main, xyz, rgb, t2, r2, lo, hi, pm, num_iter, lr, patience,
            factor, table_dtype, seam_wrap, trajectory, prune=descent_prune,
            multires=descent_multires, table_arg=descent_table,
            start_valid=final_valid, _eager=_eager,
        )
    ypr = params.ypr()
    w = torch.argmin(losses)
    rot = rot_from_ypr(ypr)
    result = LocalizeResult(
        t=params.t[w], rot=rot[w], loss=losses[w], cand_t=params.t,
        cand_ypr=ypr, cand_loss=losses, start_t=t2, start_ypr=r2, winner=w,
    )
    if trajectory:
        return result, traj
    return result


def localize_query_batch(img_init_batch, img_main_batch, xyz, rgb, trans_grid,
                         rot_grid, trans_valid, lo, hi, point_mask=None,
                         **kw) -> LocalizeResult:
    """Localize (Q, ...) panoramas of one room: :func:`localize_query` per
    query, results stacked with a leading Q axis.  A convenience API with
    no reference counterpart; the JAX package measured its one-program
    batch slower than single queries, so the port loops.  ``trajectory`` is
    not supported here."""
    if kw.get("trajectory"):
        raise ValueError("localize_query_batch returns no trajectories")
    results = [
        localize_query(ii, im, xyz, rgb, trans_grid, rot_grid, trans_valid,
                       lo, hi, point_mask, **kw)
        for ii, im in zip(img_init_batch, img_main_batch)
    ]
    return LocalizeResult(*[
        torch.stack([getattr(r, f.name) for r in results])
        for f in dataclasses.fields(LocalizeResult)
    ])
