"""Two-stage candidate trimming: loss table, then histogram match (port of
piccolo_tpu.init.refine).

Stage 2 scores a candidate by rendering the cloud's colour bins at its pose
(a z-buffered splat) and intersecting per-block histograms of that render
with the query image's.  The live splat's block counts come from the
``kernels.splat_hist`` wrapper (the kernel pair on the card, the plain
splat and block histograms on the CPU); winner-bin planes (a HistPlan's,
the mesh's decoded keys) are counted by the ``kernels.block_histogram``
wrapper.  Both wrappers launch their CUDA kernels for tensors on the card
and run their plain versions for tensors on the CPU.

Deliberate behaviour deltas from the reference (shared with the JAX
package): empty-mask candidates score +inf, and every block is computed
independently.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor, on_card, resolve_device
from ..kernels.block_histogram import block_histogram
from ..kernels.slab_sampling import make_pairs
# _ATTR_BITS and _splat_keys are also the mesh's (parallel/fused.py)
from ..kernels.splat_hist import (
    ATTR_BITS as _ATTR_BITS,
    bin_rows,
    splat_bins as _splat_bins,
    splat_block_counts,
    splat_keys as _splat_keys,
)
from ..loss import Pose, sampling_loss_packed
from ..ops.histogram import bin_ids, block_histograms
from ..ops.sampling import pack_bilinear_blocks
from ..utils import profiling
from .candidates import generate_rot_points, generate_trans_points

__all__ = [
    "SUPPORTED_CRITERIA", "check_criterion", "gather_chunk", "score_pose_grid",
    "trim_by_loss", "hist_scores", "hist_scores_core", "trim_by_hist",
    "make_input", "HistPlan", "build_hist_plan", "hist_plan_bytes",
    "hist_scores_from_planes",
]

_HIST_BINS = (8, 8, 8)  # reference utils.py:531
_NB = math.prod(_HIST_BINS)

SUPPORTED_CRITERIA = ("loss_histogram", "loss")


def check_criterion(criterion: str) -> None:
    """Raise a clear ValueError for criteria outside SUPPORTED_CRITERIA."""
    if criterion not in SUPPORTED_CRITERIA:
        raise ValueError(
            f"criterion={criterion!r} not supported "
            "('loss_histogram' or 'loss')"
        )


def _pad_rows(a: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    """``a`` padded with copies of its first row to a multiple of
    ``multiple`` rows, and its original row count."""
    n = a.shape[0]
    pad = (-n) % multiple
    if pad:
        a = torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])
    return a, n


def _pose_batch(trans: torch.Tensor, ypr: torch.Tensor) -> Pose:
    return Pose(t=trans, yaw=ypr[:, 0], pitch=ypr[:, 1], roll=ypr[:, 2])


# the gather engine's chunk on the card: as many poses as keep a chunk
# within 64 x 65,536 pair-points, from 16 to 64.  H100 80GB HBM3, 700 W
# (scripts/measure_admission.py, PERF.md's routing-values table,
# row 2): at 65,536 points 64 poses take 12-40% less wall time than 16
# (74% less at 4,096 points) and 32 poses 4-7% less at 98,304 and 131,072,
# with the same bits; at 1.05 M points no chunk above 16 saves more than
# 2.1%, and 32 and more change the last bit of some scores.  PyTorch lays
# a row's sum over threads and CTAs by the number of rows, which the rule
# keeps in one regime; so does a whole chunk, and the pipeline's grids
# (a multiple of 64 translations) give only whole chunks
_CARD_CHUNK_PAIR_POINTS = 64 * 65536


def gather_chunk(n_points: int, device) -> int:
    """Poses the gather engine scores at once for a cloud of ``n_points``
    on ``device``: 16, the JAX package's, off the card; on the card the
    largest of 64, 32 and 16 within ``_CARD_CHUNK_PAIR_POINTS``.  Each
    pair's loss is summed within its own chunk; on the card a chunk of
    fewer than 16 poses sums in another order, so scores keep their bits
    across chunks where every chunk is whole."""
    chunk = 64 if on_card(device) else 16
    while chunk > 16 and chunk * n_points > _CARD_CHUNK_PAIR_POINTS:
        chunk //= 2
    return chunk


def _score_pairs(img, xyz, rgb, pair_t, pair_ypr, point_mask, chunk: int,
                 wrap: bool = False) -> torch.Tensor:
    """Sampling loss of every (t, ypr) pair, ``chunk`` poses at a time (the
    gather engine of stage 1)."""
    H, W, _ = img.shape
    blocks = pack_bilinear_blocks(img, wrap=wrap)
    return torch.cat([
        sampling_loss_packed(
            _pose_batch(pair_t[c:c + chunk], pair_ypr[c:c + chunk]),
            xyz, rgb, blocks, H, W, point_mask, wrap=wrap,
        )
        for c in range(0, pair_t.shape[0], chunk)
    ])


def score_pose_grid(img, xyz, rgb, trans, rot, point_mask=None,
                    chunk: int = 16, valid=None,
                    wrap: bool = False) -> torch.Tensor:
    """Loss table over the trans x rot grid, flattened trans-major;
    ``valid`` marks padding rows of ``trans`` whose scores become +inf."""
    pair_t, pair_r = make_pairs(trans, rot)
    scores = _score_pairs(img, xyz, rgb, pair_t, pair_r, point_mask, chunk,
                          wrap)
    if valid is not None:
        keep = torch.repeat_interleave(valid, rot.shape[0])
        scores = torch.where(keep, scores, torch.full_like(scores, math.inf))
    return scores


def trim_by_loss(img, xyz, rgb, trans, rot, num_keep: int, point_mask=None,
                 valid=None, wrap: bool = False):
    """The num_keep (trans, rot) pairs of lowest sampling loss (stable
    ascending order, pair recovered by divmod over len(rot))."""
    R = rot.shape[0]
    scores = score_pose_grid(img, xyz, rgb, trans, rot, point_mask,
                             valid=valid, wrap=wrap)
    k = min(num_keep, scores.shape[0])
    idx = torch.sort(scores, stable=True).indices[:k]
    return trans[idx // R], rot[idx % R]


def _hist_query_side(img):
    """The query image scaled to [0, 255] and its nonzero-pixel mask."""
    img255 = img * 255.0
    return img255, (img255 == 0.0).sum(-1) != 3


def _point_bins(rgb, nb):
    """Per-point colour bins; pure-black points -> the sentinel bin ``nb``."""
    rgb255 = rgb * 255.0
    bins = bin_ids(rgb255, _HIST_BINS)
    black = (rgb255 == 0.0).sum(-1) == 3
    return torch.where(black, torch.full_like(bins, nb), bins)


def _pix_ok(img_mask, sh, sw):
    """(H*W,) the pixels a block histogram counts: nonzero query pixels
    inside the block grid."""
    H, W = img_mask.shape
    bh, bw = H // sh, W // sw
    dev = img_mask.device
    in_grid = ((torch.arange(H, device=dev)[:, None] // bh < sh)
               & (torch.arange(W, device=dev)[None, :] // bw < sw))
    return (img_mask & in_grid).reshape(-1)


@dataclasses.dataclass
class _QuerySide:
    img_hn: torch.Tensor  # (sh*sw, nb) normalised query block histograms
    img_c: torch.Tensor  # (sh*sw,) query pixel counts
    middle: torch.Tensor  # (sh*sw,) block rows 1..sh-2
    pix_ok: torch.Tensor  # (H*W,) see _pix_ok
    grid: Tuple[int, int, int, int]  # H, W, sh, sw
    n_blocks: int


def _query_side(img, sh, sw) -> _QuerySide:
    H, W, _ = img.shape
    img255, img_mask = _hist_query_side(img)
    img_h, img_c = block_histograms(img255, img_mask, _HIST_BINS, sh, sw)
    img_hn = img_h / img_c.clamp_min(1e-12)[:, None]
    row_ids = torch.arange(sh * sw, device=img.device) // sw
    middle = (row_ids >= 1) & (row_ids <= sh - 2)
    return _QuerySide(img_hn, img_c, middle, _pix_ok(img_mask, sh, sw),
                      (H, W, sh, sw), sh * sw)


def _score_from_counts(ph: torch.Tensor, q: _QuerySide) -> torch.Tensor:
    """Blockwise histogram-intersection score of each candidate, (k,), from
    its (k, sh*sw, 512) block counts."""
    pc = ph.sum(-1)
    phn = ph / pc.clamp_min(1e-12)[..., None]
    inter = torch.minimum(phn, q.img_hn).sum(-1)
    ok = (pc > 0) & (q.img_c > 0) & q.middle
    return (inter * ok).sum(-1) / q.n_blocks


def _score_from_pbin(pbin: torch.Tensor, q: _QuerySide) -> torch.Tensor:
    """:func:`_score_from_counts` from (k, H*W) per-pixel winner bins (a
    HistPlan's planes or the mesh's decoded keys), counted by the block
    histogram.  Out-of-range bins (no splat / sentinel) are masked out."""
    k = pbin.shape[0]
    ph = block_histogram(*bin_rows(pbin, q.pix_ok, *q.grid), _NB)
    return _score_from_counts(ph.reshape(k, q.n_blocks, _NB), q)


def hist_scores_core(img, xyz, rgb, trans, ypr, pm, num_split_h: int,
                     num_split_w: int, chunk: int) -> torch.Tensor:
    """Histogram-trim score per candidate (higher is better) from a live
    splat: the candidates' block counts, ``chunk`` candidates splatted at a
    time (``kernels.splat_hist``), then the intersection with the query's.
    Counts ``stage2.splat_kernel`` or ``stage2.splat_plain`` (n:
    candidates)."""
    H, W, _ = img.shape
    q = _query_side(img, num_split_h, num_split_w)
    counts = splat_block_counts(xyz, _point_bins(rgb, _NB), trans, ypr, pm,
                                q.pix_ok, H, W, num_split_h, num_split_w,
                                chunk)
    profiling.count("stage2.splat_kernel" if counts.is_cuda
                    else "stage2.splat_plain", trans.shape[0])
    return _score_from_counts(counts, q)


def hist_scores(img, xyz, rgb, trans, ypr, point_mask=None, *,
                num_split_h: int, num_split_w: int, chunk: int = 8,
                masked: bool = False) -> torch.Tensor:
    """Blockwise histogram-intersection score per candidate (higher is
    better); ``point_mask`` applies when ``masked``."""
    return hist_scores_core(img, xyz, rgb, trans, ypr,
                            point_mask if masked else None, num_split_h,
                            num_split_w, chunk)


def trim_by_hist(img, xyz, rgb, trans, rot, num_input: int, num_split_h: int,
                 num_split_w: int, point_mask=None):
    """The num_input candidates with the highest histogram score (stable
    argsort, taken from the top: among ties the higher index first).  The
    candidates are padded to a multiple of 8 rows, as in the JAX package,
    so the block-histogram kernel sees the same shapes."""
    trans_p, n = _pad_rows(trans, 8)
    rot_p, _ = _pad_rows(rot, 8)
    scores = hist_scores(img, xyz, rgb, trans_p, rot_p, point_mask,
                         num_split_h=num_split_h, num_split_w=num_split_w,
                         masked=point_mask is not None)[:n]
    k = min(num_input, scores.shape[0])
    idx = torch.sort(scores, stable=True).indices[-k:].flip(0)
    return trans[idx], rot[idx]


@dataclasses.dataclass
class HistPlan:
    """Room-static stage-2 winner-bin planes: (n_pairs, H*W) int16 in
    make_pairs order over the real grid rows; background pixels hold the
    sentinel bin 512.  Invalid under per-query colour rebinds."""

    planes: torch.Tensor
    n_pairs: int
    height: int
    width: int

    @property
    def nbytes(self) -> int:
        return self.planes.numel() * self.planes.element_size()


def hist_plan_bytes(n_pairs: int, height: int, width: int) -> int:
    """Exact footprint of a HistPlan (an int16 bin per pixel per pair)."""
    return n_pairs * height * width * 2


def build_hist_plan(xyz, rgb, trans, rot, height: int, width: int,
                    point_mask=None, chunk: int = 16,
                    device="cuda") -> HistPlan:
    """Winner-bin planes for every (trans, rot) pair of the real grid,
    ``chunk`` splats at a time."""
    dev = resolve_device(device)
    xyz = as_tensor(xyz, dev, torch.float32)
    rgb = as_tensor(rgb, dev, torch.float32)
    pm = None if point_mask is None else as_tensor(point_mask, dev, torch.bool)
    pair_t, pair_r = make_pairs(as_tensor(trans, dev, torch.float32),
                                as_tensor(rot, dev, torch.float32))
    rgb_bins = _point_bins(rgb, _NB)
    planes = []
    for c in range(0, pair_t.shape[0], chunk):
        pbin = _splat_bins(xyz, rgb_bins, pair_t[c:c + chunk],
                           pair_r[c:c + chunk], pm, height, width)
        ok = (pbin >= 0) & (pbin < _NB)
        planes.append(torch.where(ok, pbin, torch.full_like(pbin, _NB))
                      .to(torch.int16))
    return HistPlan(torch.cat(planes), pair_t.shape[0], height, width)


def hist_scores_from_planes(img, planes_sel: torch.Tensor, num_split_h: int,
                            num_split_w: int) -> torch.Tensor:
    """:func:`hist_scores_core` from precomputed (k, H*W) winner-bin planes
    (the selected candidates' rows of a HistPlan)."""
    q = _query_side(img, num_split_h, num_split_w)
    return _score_from_pbin(planes_sel.to(torch.int32), q)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def make_input(img, xyz, rgb, num_input: int, init_dict: Dict,
               criterion: str = "loss_histogram",
               num_intermediate: Optional[int] = None, point_mask=None,
               seed: int = 2, wrap: bool = False,
               device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """The staged init: candidate grids, the loss trim, then the histogram
    trim; returns numpy (num_input, 3) starting translations and
    rotations.

    The grids come from the valid points only.  ``sample_rate_for_init``
    in ``init_dict`` keeps each valid point with probability 1/rate (one
    numpy draw from ``default_rng(seed)`` over the valid points, scattered
    back to the padded layout) by narrowing the mask.  ``criterion="loss"``
    keeps the top ``num_input`` pairs by loss and skips the histogram
    trim."""
    check_criterion(criterion)
    dev = resolve_device(device)
    xyz_np_full = _host(xyz)
    mask_np = None if point_mask is None else _host(point_mask).astype(bool)
    xyz_np = xyz_np_full if mask_np is None else xyz_np_full[mask_np]
    f32 = torch.float32
    rot = torch.as_tensor(np.asarray(generate_rot_points(init_dict), np.float32),
                          device=dev)
    trans = torch.as_tensor(
        np.asarray(generate_trans_points(xyz_np, init_dict), np.float32),
        device=dev)
    img = as_tensor(img, dev, f32)
    xyz = as_tensor(xyz, dev, f32)
    rgb = as_tensor(rgb, dev, f32)
    mask = None if mask_np is None else torch.as_tensor(mask_np, device=dev)
    rate = init_dict.get("sample_rate_for_init")
    if rate is not None:
        draw = np.random.default_rng(seed).random(xyz_np.shape[0]) < 1.0 / rate
        if mask_np is None:
            keep = draw
        else:
            keep = np.zeros(xyz_np_full.shape[0], bool)
            keep[mask_np] = draw
        keep = torch.as_tensor(keep, device=dev)
        mask = keep if mask is None else mask & keep

    if criterion == "loss":
        t2, r2 = trim_by_loss(img, xyz, rgb, trans, rot, num_input, mask,
                              wrap=wrap)
    else:
        t1, r1 = trim_by_loss(img, xyz, rgb, trans, rot, num_intermediate,
                              mask, wrap=wrap)
        t2, r2 = trim_by_hist(img, xyz, rgb, t1, r1, num_input,
                              init_dict["num_split_h"],
                              init_dict["num_split_w"], mask)
    return t2.cpu().numpy(), r2.cpu().numpy()
