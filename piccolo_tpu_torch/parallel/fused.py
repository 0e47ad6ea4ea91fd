"""One query's three stages over a ('cand', 'point') mesh of devices (port
of piccolo_tpu.parallel.fused).

  stage 1  the candidate pairs split contiguously over the cand groups;
           each shard scores its group's pairs against its slice of the
           cloud (the gather engine, or the slab kernel on a
           :class:`ShardedGridPlan`), and the group's lead adds the shards'
           (loss sum, count) in shard order;
  top-k    the scores are gathered on the mesh's lead device;
  stage 2  the survivors split over the cand groups; each shard z-buffers
           its own points into packed min keys, the lead takes their
           minimum (exact: the splat is a scatter-min) and the block
           histogram kernel scores the group's candidates, or the selected
           rows of a :class:`ShardedHistPlan` are fetched from the groups
           that hold them;
  stage 3  the sharded multi-start descent (``sharding.descent_local``).

Selections follow ``pipeline.localize_query`` (stable sorts, validity
carried through, clone rows for scarce valid pairs); only stage 1's and
the descent's sums add in another order than on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..device import as_tensor
from ..init.refine import (
    _ATTR_BITS,
    _NB,
    HistPlan,
    _point_bins,
    _pose_batch,
    _query_side,
    _score_from_pbin,
    _splat_keys,
    check_criterion,
    hist_scores_from_planes,
)
from ..kernels.slab_sampling import (
    GROUP,
    GridPlan,
    PlanOverBudget,
    _check_plan_image,
    _check_refresh,
    build_grid_plan,
    make_pairs,
    nb_bucket,
    plan_exact_bytes,
    plan_group_sums,
    plan_required_blocks,
    resolve_plan_geometry,
    slab_table,
)
from ..loss import masked_mean, sampling_partials_packed
from ..ops.pano import attr_min_decode
from ..ops.rotation import rot_from_ypr
from ..ops.sampling import pack_bilinear_blocks
from ..pipeline import LocalizeResult
from ..solver import _check_prune
from .sharding import (
    Mesh,
    ShardedCloud,
    descent_local,
    shard_cloud,
)

__all__ = [
    "localize_query_sharded",
    "shard_cloud",
    "ShardedGridPlan",
    "ShardedHistPlan",
    "shard_grid_plan",
    "shard_hist_plan",
]


@dataclasses.dataclass
class ShardedGridPlan:
    """Slab plans laid out on a mesh: ``plans[c][p]`` holds cand group c's
    share of the plan over point slice p, on device (c, p).

    Stage-1 samples factor over points, so each point slice gets a plan of
    its own (its point ids index the slice's colours, so a per-query
    re-bake works per shard), and the plan's 128-pair groups split
    contiguously over the cand groups.  Every shard shares one geometry and
    one block count.  ``n_pairs`` and the flags are the plan's;
    ``card_bytes`` is what each device holds, by ``plan_exact_bytes`` from
    the sizing pass, before the streams were built."""

    plans: List[List[GridPlan]]
    n_pairs: int
    height: int
    width: int
    wrap: bool
    window: int
    block: int
    compact: bool
    tp_is_pid: bool
    quant: bool
    mesh_key: Tuple[str, ...]
    card_bytes: Dict[str, int]

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for row in self.plans for p in row)


def _card_bytes(mesh: Mesh, shard_bytes) -> Dict[torch.device, int]:
    """Bytes each device of the mesh holds, from ``shard_bytes(c, p)``: a
    device that appears more than once holds all of its shards."""
    held: Dict[torch.device, int] = {}
    for (c, p), dev in np.ndenumerate(mesh.devices):
        held[dev] = held.get(dev, 0) + shard_bytes(c, p)
    return held


def _group_ranges(n_groups: int, n_cand: int):
    per = -(-n_groups // n_cand)
    return [(min(c * per, n_groups), min((c + 1) * per, n_groups))
            for c in range(n_cand)]


def shard_grid_plan(mesh: Mesh, xyz, rgb, point_mask, trans_grid, rot_grid,
                    height: int, width: int, compact: bool = False,
                    tp_is_pid: bool = False, wrap: bool = False,
                    quant: bool = False,
                    bytes_cap: Optional[int] = None) -> ShardedGridPlan:
    """Per-shard slab plans for :func:`localize_query_sharded`, built on
    the shards' own devices.

    ``xyz``/``rgb``/``point_mask`` are the whole cloud, split as
    :func:`shard_cloud` splits it.  ``trans_grid`` holds the real grid rows
    only.  ``bytes_cap`` bounds what each device holds (the sum of its
    shards' exact bytes, so a mesh that repeats a card adds its shards up):
    over it, :class:`PlanOverBudget` is raised before any stream is
    built."""
    if quant and not compact:
        raise ValueError("quant=True is a sub-mode of compact plans "
                         "(pass compact=True)")
    cloud = shard_cloud(mesh, xyz, rgb, point_mask)
    n_cand, n_point = mesh.shape["cand"], mesh.shape["point"]
    per = cloud.rows // n_point
    devs = mesh.devices
    # one geometry and one block count for every shard
    window, block = resolve_plan_geometry(per, height, width,
                                          device=devs[0, 0])
    trans = [as_tensor(trans_grid, devs[0, p], torch.float32)
             for p in range(n_point)]
    rot = [as_tensor(rot_grid, devs[0, p], torch.float32)
           for p in range(n_point)]
    nb = nb_bucket(max(
        plan_required_blocks(cloud.xyz[0][p], cloud.mask[0][p], trans[p],
                             rot[p], height, width, wrap=wrap, window=window,
                             block=block, device=devs[0, p])
        for p in range(n_point)))
    n_pairs = int(trans[0].shape[0]) * int(rot[0].shape[0])
    ranges = _group_ranges(-(-n_pairs // GROUP), n_cand)
    held = _card_bytes(mesh, lambda c, p: plan_exact_bytes(
        ranges[c][1] - ranges[c][0], nb, compact, block, quant=quant))
    if bytes_cap is not None and max(held.values()) > bytes_cap:
        raise PlanOverBudget(max(held.values()), bytes_cap)
    plans = [[build_grid_plan(
        cloud.xyz[c][p], cloud.rgb[c][p], cloud.mask[c][p], trans_grid,
        rot_grid, height, width, compact=compact, tp_is_pid=tp_is_pid, nb=nb,
        wrap=wrap, window=window, block=block, quant=quant, device=dev,
        groups=ranges[c]) for p, dev in enumerate(row)]
        for c, row in enumerate(devs)]
    return ShardedGridPlan(plans, n_pairs, height, width, wrap, window, block,
                           compact, tp_is_pid, quant, mesh.fingerprint(),
                           {str(d): n for d, n in held.items()})


@dataclasses.dataclass
class ShardedHistPlan:
    """Stage-2 winner-bin planes laid out on a mesh: ``planes[c]`` holds
    rows [c * per, (c + 1) * per) of the plan on cand group c's lead
    device."""

    planes: List[torch.Tensor]
    per: int
    n_pairs: int
    height: int
    width: int
    mesh_key: Tuple[str, ...]

    @property
    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.planes)

    @property
    def card_bytes(self) -> Dict[str, int]:
        """Bytes each device holds (a device may lead several groups)."""
        held: Dict[str, int] = {}
        for p in self.planes:
            held[str(p.device)] = (held.get(str(p.device), 0)
                                   + p.numel() * p.element_size())
        return held


def shard_hist_plan(mesh: Mesh, plan: HistPlan) -> ShardedHistPlan:
    """Split a :class:`HistPlan`'s planes contiguously over the cand groups
    (each group's share on its lead device: the planes do not depend on the
    points).  A device then holds ``nbytes / n_cand``; the selected rows
    move once a query."""
    n_cand = mesh.shape["cand"]
    per = -(-plan.planes.shape[0] // n_cand)
    planes = [plan.planes[c * per:(c + 1) * per].to(mesh.devices[c, 0])
              for c in range(n_cand)]
    return ShardedHistPlan(planes, per, plan.n_pairs, plan.height, plan.width,
                           mesh.fingerprint())


def _pad_clone_rows(a: torch.Tensor, multiple: int) -> torch.Tensor:
    """``a`` padded to a multiple of ``multiple`` rows with copies of row
    0."""
    pad = (-a.shape[0]) % multiple
    if pad:
        a = torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])
    return a


class _PerDevice:
    """One value per device, made at first use (tables, query sides)."""

    def __init__(self, make):
        self.make, self.held = make, {}

    def __call__(self, dev):
        if dev not in self.held:
            self.held[dev] = self.make(dev)
        return self.held[dev]


def _combine_scores(parts_by_group, lead):
    """Per group of pairs, its shards' (total, count) on the group's lead,
    added there in shard order; the means (+inf without a sample),
    gathered on ``lead``."""
    scores = []
    for parts in parts_by_group:
        tot, cnt = parts[0]
        for t, n in parts[1:]:
            tot, cnt = tot + t, cnt + n
        scores.append(masked_mean(tot, cnt).to(lead))
    return torch.cat(scores)


def _stage1_gather(mesh, cloud, img_init, pair_t, pair_r, grid_chunk, wrap):
    """Stage 1 on the gather engine: group c's slice of the (padded) pairs,
    ``grid_chunk`` poses at a time, against each shard's points."""
    n_cand = mesh.shape["cand"]
    H, W, _ = img_init.shape
    blocks = _PerDevice(lambda d: pack_bilinear_blocks(img_init.to(d),
                                                       wrap=wrap))
    kc = pair_t.shape[0] // n_cand
    by_group = []
    for c, row in enumerate(mesh.devices):
        parts = []
        for p, dev in enumerate(row):
            pt = pair_t[c * kc:(c + 1) * kc].to(dev)
            pr = pair_r[c * kc:(c + 1) * kc].to(dev)
            sums = [sampling_partials_packed(
                _pose_batch(pt[i:i + grid_chunk], pr[i:i + grid_chunk]),
                cloud.xyz[c][p], cloud.rgb[c][p], blocks(dev), H, W,
                cloud.mask[c][p], wrap) for i in range(0, kc, grid_chunk)]
            parts.append((torch.cat([s[0] for s in sums]).to(row[0]),
                          torch.cat([s[1] for s in sums]).to(row[0])))
        by_group.append(parts)
    return _combine_scores(by_group, mesh.lead)


def _stage1_slab(mesh, plan: ShardedGridPlan, cloud, img_init,
                 refresh: bool):
    """Stage 1 on the slab kernel: every shard's plan groups against its
    device's table; a group's (total, count) added over the point shards."""
    tables = _PerDevice(lambda d: slab_table(img_init.to(d), wrap=plan.wrap,
                                             window=plan.window))
    by_group = []
    for c, row in enumerate(mesh.devices):
        shard_sums = [plan_group_sums(
            tables(dev), plan.plans[c][p],
            cloud.rgb[c][p] if refresh else None)
            for p, dev in enumerate(row)]
        # one entry per slab group of this cand group: its shards' sums
        by_group += [[(t.to(row[0]), n.to(row[0])) for t, n in group]
                     for group in zip(*shard_sums)]
    return _combine_scores(by_group, mesh.lead)


def _stage2_splat(mesh, cloud, img_init, t1, r1, sh, sw, hist_chunk):
    """Stage 2 from the live splat: group c's slice of the (padded)
    survivors; each shard z-buffers its points, the group's lead takes the
    minimum of the shards' keys, decodes the winner bins and scores them."""
    n_cand = mesh.shape["cand"]
    H, W, _ = img_init.shape
    kc = t1.shape[0] // n_cand
    bins = [[_point_bins(cloud.rgb[c][p], _NB) for p in range(len(row))]
            for c, row in enumerate(mesh.devices)]
    scores = []
    for c, row in enumerate(mesh.devices):
        lead = row[0]
        pbins = []
        for i in range(c * kc, (c + 1) * kc, hist_chunk):
            keys = None
            for p, dev in enumerate(row):
                k = _splat_keys(cloud.xyz[c][p], bins[c][p],
                                t1[i:i + hist_chunk].to(dev),
                                r1[i:i + hist_chunk].to(dev),
                                cloud.mask[c][p], H, W).to(lead)
                keys = k if keys is None else torch.minimum(keys, k)
            pbins.append(attr_min_decode(keys, _ATTR_BITS))
        q = _query_side(img_init.to(lead), sh, sw)
        scores.append(_score_from_pbin(torch.cat(pbins), q).to(mesh.lead))
    return torch.cat(scores)


def _stage2_planes(mesh, hist_plan: ShardedHistPlan, img_init, idx, sh, sw):
    """Stage 2 from the planes: group c's slice of the (padded) selected
    pair indices, each row fetched from the group that holds it."""
    n_cand = mesh.shape["cand"]
    kc = idx.shape[0] // n_cand
    idx_host = idx.cpu()
    scores = []
    for c, row in enumerate(mesh.devices):
        lead = row[0]
        mine = idx_host[c * kc:(c + 1) * kc]
        owner = mine // hist_plan.per
        rows = torch.empty((kc, hist_plan.height * hist_plan.width),
                           dtype=hist_plan.planes[0].dtype, device=lead)
        for o in torch.unique(owner).tolist():
            at = (owner == o).nonzero()[:, 0]
            local = (mine[at] - o * hist_plan.per).to(mesh.devices[o, 0])
            rows[at.to(lead)] = hist_plan.planes[o][local].to(lead)
        scores.append(hist_scores_from_planes(img_init.to(lead), rows, sh, sw)
                      .to(mesh.lead))
    return torch.cat(scores)


def _check_sharded_plans(mesh, plan, hist_plan, img_init, T, R, seam_wrap,
                         plan_refresh_rgb, rgb_rebound):
    key = mesh.fingerprint()
    if plan is not None:
        if plan.mesh_key != key:
            raise ValueError(f"sharded plan was laid out on {plan.mesh_key}, "
                             f"not on this mesh ({key})")
        if plan.wrap != seam_wrap:
            raise ValueError(f"sharded plan was built with wrap={plan.wrap} "
                             f"but seam_wrap={seam_wrap}")
        _check_plan_image(plan, int(img_init.shape[0]), int(img_init.shape[1]))
        if plan.n_pairs > T * R or plan.n_pairs % R:
            raise ValueError(f"sharded plan covers {plan.n_pairs} pairs but "
                             f"the grids imply {T}x{R}={T * R} (stale plan?)")
        _check_refresh(plan.compact, plan.tp_is_pid,
                       rgb_rebound if plan_refresh_rgb else None)
    if hist_plan is not None:
        if hist_plan.mesh_key != key:
            raise ValueError(f"hist_plan was laid out on {hist_plan.mesh_key},"
                             f" not on this mesh ({key})")
        ih, iw = int(img_init.shape[0]), int(img_init.shape[1])
        if (hist_plan.height, hist_plan.width) != (ih, iw):
            raise ValueError(
                f"hist_plan was built for a {hist_plan.height}x"
                f"{hist_plan.width} init image but the query image is "
                f"({ih}, {iw})")
        if hist_plan.n_pairs > T * R or hist_plan.n_pairs % R:
            raise ValueError(
                f"hist_plan covers {hist_plan.n_pairs} pairs but the grids "
                f"imply {T}x{R}={T * R} (stale plan? rebuild for these "
                "grids)")
        if plan_refresh_rgb:
            raise ValueError(
                "hist_plan bakes point colour bins at build time — a "
                "per-query rgb rebind (plan_refresh_rgb) invalidates it; "
                "pass hist_plan=None for colour-rebinding queries")


def localize_query_sharded(
    mesh: Mesh,
    img_init,
    img_main,
    xyz,
    rgb,
    trans_grid,
    rot_grid,
    trans_valid,
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
    grid_chunk: int = 16,
    hist_chunk: int = 4,
    descent_table: str = "auto",
    plan: Optional[ShardedGridPlan] = None,
    plan_refresh_rgb: bool = False,
    hist_plan: Optional[ShardedHistPlan] = None,
    seam_wrap: bool = False,
    criterion: str = "loss_histogram",
    descent_prune=None,
    exec_cache_dir=None,
    _eager: bool = False,
) -> LocalizeResult:
    """Localize one panorama over a ('cand', 'point') mesh: the contract of
    ``pipeline.localize_query`` (candidate grids padded by the caller; the
    same :class:`LocalizeResult`, on the mesh's lead device).

    ``xyz`` is the raw cloud or a :class:`ShardedCloud` (then
    ``point_mask`` is ignored and ``rgb`` is None for the cloud's own
    colours, or a per-query rebind).  ``plan`` (:func:`shard_grid_plan`)
    scores stage 1 with the slab kernel per shard; ``plan_refresh_rgb``
    re-bakes its targets from ``rgb``.  ``hist_plan``
    (:func:`shard_hist_plan`) replaces stage 2's live splat.
    ``criterion="loss"`` skips stage 2.  ``descent_prune=(k, m)`` prunes
    the descent over the mesh (``sharding.descent_local``).  On the card
    the descent replays captured graphs; ``_eager=True`` runs the same
    steps eagerly.  ``exec_cache_dir``: the process's kernel libraries from
    the executable cache (``utils.exec_cache.warm``, once a process)."""
    check_criterion(criterion)
    lead = mesh.lead
    if exec_cache_dir:
        from ..utils import exec_cache

        exec_cache.warm(exec_cache_dir, lead)
    f32 = torch.float32
    if isinstance(xyz, ShardedCloud):
        if xyz.mesh_key != mesh.fingerprint():
            raise ValueError("the sharded cloud was laid out on another mesh")
        cloud = xyz if rgb is None else xyz.with_rgb(mesh, rgb)
    else:
        cloud = shard_cloud(mesh, xyz, rgb, point_mask)
    img_init = as_tensor(img_init, lead, f32)
    img_main = as_tensor(img_main, lead, f32)
    trans_grid = as_tensor(trans_grid, lead, f32)
    rot_grid = as_tensor(rot_grid, lead, f32)
    trans_valid = as_tensor(trans_valid, lead, torch.bool)
    lo = as_tensor(lo, lead, f32)
    hi = as_tensor(hi, lead, f32)
    T, R = trans_grid.shape[0], rot_grid.shape[0]
    _check_sharded_plans(mesh, plan, hist_plan, img_init, T, R, seam_wrap,
                         plan_refresh_rgb, cloud.rgb)
    n_cand = mesh.shape["cand"]

    # ---- stage 1: the loss table, pairs split over the cand groups
    with record_function("localize.stage1_loss_table"):
        pair_t, pair_r = make_pairs(trans_grid, rot_grid)
        pair_valid = torch.repeat_interleave(trans_valid, R)
        if plan is not None:
            scores = _stage1_slab(mesh, plan, cloud, img_init,
                                  plan_refresh_rgb)
            scores = scores[:min(plan.n_pairs, T * R)]
            if scores.shape[0] < T * R:
                scores = torch.cat([scores, torch.full(
                    (T * R - scores.shape[0],), math.inf, device=lead)])
        else:
            mult = n_cand * grid_chunk
            scores = _stage1_gather(
                mesh, cloud, img_init, _pad_clone_rows(pair_t, mult),
                _pad_clone_rows(pair_r, mult), grid_chunk, seam_wrap)[:T * R]
        scores = torch.where(pair_valid, scores,
                             torch.full_like(scores, math.inf))
        k1 = min(num_intermediate if criterion == "loss_histogram"
                 else num_input, T * R)
        top1 = torch.sort(scores, stable=True)
        idx1 = top1.indices[:k1]
        sel_valid = torch.isfinite(top1.values[:k1])
        t1, r1 = pair_t[idx1], pair_r[idx1]

    if criterion == "loss":
        t2, r2, final_valid = t1, r1, sel_valid
    else:
        # ---- stage 2: the survivors split over the cand groups
        with record_function("localize.stage2_hist_trim"):
            mult = n_cand * hist_chunk
            if hist_plan is not None:
                idx = _pad_clone_rows(idx1.clamp_max(hist_plan.n_pairs - 1),
                                      mult)
                hs = _stage2_planes(mesh, hist_plan, img_init, idx,
                                    num_split_h, num_split_w)[:k1]
            else:
                hs = _stage2_splat(mesh, cloud, img_init,
                                   _pad_clone_rows(t1, mult),
                                   _pad_clone_rows(r1, mult), num_split_h,
                                   num_split_w, hist_chunk)[:k1]
            hs = torch.where(sel_valid, hs, torch.full_like(hs, -math.inf))
            k2 = min(num_input, k1)
            idx2 = torch.sort(-hs, stable=True).indices[:k2]
            t2, r2 = t1[idx2], r1[idx2]
            final_valid = sel_valid[idx2]
    # fewer valid pairs than starts: clone the best valid start
    t2 = torch.where(final_valid[:, None], t2, t2[0])
    r2 = torch.where(final_valid[:, None], r2, r2[0])
    k2 = t2.shape[0]

    # ---- stage 3: the descent over the mesh
    with record_function("localize.stage3_descent"):
        prune = _check_prune(descent_prune, num_iter, k2, False)
        t2p, r2p = _pad_clone_rows(t2, n_cand), _pad_clone_rows(r2, n_cand)
        v2p = torch.cat([final_valid, torch.zeros(
            t2p.shape[0] - k2, dtype=torch.bool, device=lead)])
        t, ypr, losses, _ = descent_local(
            mesh, cloud, img_main, t2p, r2p, lo, hi, v2p, num_iter=num_iter,
            lr=lr, patience=patience, factor=factor,
            table_dtype=descent_table, wrap=seam_wrap, prune=prune,
            n_valid=k2, _eager=_eager)
    t, ypr, losses = t[:k2], ypr[:k2], losses[:k2]
    w = torch.argmin(losses)
    rot = rot_from_ypr(ypr)
    return LocalizeResult(t=t[w], rot=rot[w], loss=losses[w], cand_t=t,
                          cand_ypr=ypr, cand_loss=losses, start_t=t2,
                          start_ypr=r2, winner=w)
