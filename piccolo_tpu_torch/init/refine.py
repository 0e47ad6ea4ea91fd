"""Two-stage candidate trimming: loss table, then histogram match (port of
piccolo_tpu.init.refine).

Stage 2 scores a candidate by rendering the cloud's colour bins at its pose
(a z-buffered splat) and intersecting per-block histograms of that render
with the query image's.  The block histograms always go through the
``kernels.block_histogram`` wrapper, which launches the CUDA kernel for
tensors on the card and runs the plain version for tensors on the CPU.

Deliberate behaviour deltas from the reference (shared with the JAX
package): empty-mask candidates score +inf, and every block is computed
independently.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..device import as_tensor, resolve_device
from ..kernels.block_histogram import block_histogram
from ..kernels.slab_sampling import make_pairs
from ..loss import Pose, sampling_loss_packed, transform_cloud
from ..ops.histogram import bin_ids, block_histograms
from ..ops.pano import attr_min_decode, attr_min_keys
from ..ops.sampling import pack_bilinear_blocks

__all__ = [
    "SUPPORTED_CRITERIA", "check_criterion", "score_pose_grid",
    "trim_by_loss", "hist_scores_core", "trim_by_hist", "HistPlan",
    "build_hist_plan", "hist_plan_bytes", "hist_scores_from_planes",
]

_HIST_BINS = (8, 8, 8)  # reference utils.py:531
_NB = math.prod(_HIST_BINS)
_ATTR_BITS = 10  # bins 0..512, the background sentinel included

SUPPORTED_CRITERIA = ("loss_histogram", "loss")


def check_criterion(criterion: str) -> None:
    """Raise a clear ValueError for criteria outside SUPPORTED_CRITERIA."""
    if criterion not in SUPPORTED_CRITERIA:
        raise ValueError(
            f"criterion={criterion!r} not supported "
            "('loss_histogram' or 'loss')"
        )


def _pose_batch(trans: torch.Tensor, ypr: torch.Tensor) -> Pose:
    return Pose(t=trans, yaw=ypr[:, 0], pitch=ypr[:, 1], roll=ypr[:, 2])


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


def _block_grid(H, W, sh, sw, img_mask):
    """The valid-pixel selector (nonzero query pixels inside the block grid)
    and the (k, H*W) -> (k, sh*sw, bh*bw) regrouping."""
    bh, bw = H // sh, W // sw
    dev = img_mask.device
    in_grid = ((torch.arange(H, device=dev)[:, None] // bh < sh)
               & (torch.arange(W, device=dev)[None, :] // bw < sw))
    pix_ok = (img_mask & in_grid).reshape(-1)

    def block_layout(flat):
        k = flat.shape[0]
        return (flat.reshape(k, H, W)[:, :sh * bh, :sw * bw]
                .reshape(k, sh, bh, sw, bw)
                .permute(0, 1, 3, 2, 4)
                .reshape(k, sh * sw, bh * bw))

    return pix_ok, block_layout


@dataclasses.dataclass
class _QuerySide:
    img_hn: torch.Tensor  # (sh*sw, nb) normalised query block histograms
    img_c: torch.Tensor  # (sh*sw,) query pixel counts
    middle: torch.Tensor  # (sh*sw,) block rows 1..sh-2
    pix_ok: torch.Tensor
    block_layout: object
    n_blocks: int


def _query_side(img, sh, sw) -> _QuerySide:
    H, W, _ = img.shape
    img255, img_mask = _hist_query_side(img)
    img_h, img_c = block_histograms(img255, img_mask, _HIST_BINS, sh, sw)
    img_hn = img_h / img_c.clamp_min(1e-12)[:, None]
    row_ids = torch.arange(sh * sw, device=img.device) // sw
    middle = (row_ids >= 1) & (row_ids <= sh - 2)
    pix_ok, block_layout = _block_grid(H, W, sh, sw, img_mask)
    return _QuerySide(img_hn, img_c, middle, pix_ok, block_layout, sh * sw)


def _score_from_pbin(pbin: torch.Tensor, q: _QuerySide) -> torch.Tensor:
    """Blockwise histogram-intersection score of each candidate, (k,), from
    its (k, H*W) per-pixel winner bins (a splat or a precomputed plane).
    Out-of-range bins (no splat / sentinel) are masked out either way."""
    k = pbin.shape[0]
    valid = (pbin >= 0) & (pbin < _NB) & q.pix_ok
    ids = q.block_layout(pbin.clamp(0, _NB - 1).to(torch.int32))
    msk = q.block_layout(valid.to(torch.float32))
    ph = block_histogram(ids.reshape(k * q.n_blocks, -1).contiguous(),
                         msk.reshape(k * q.n_blocks, -1).contiguous(), _NB)
    ph = ph.reshape(k, q.n_blocks, _NB)
    pc = ph.sum(-1)
    phn = ph / pc.clamp_min(1e-12)[..., None]
    inter = torch.minimum(phn, q.img_hn).sum(-1)
    ok = (pc > 0) & (q.img_c > 0) & q.middle
    return (inter * ok).sum(-1) / q.n_blocks


def _splat_bins(xyz, rgb_bins, trans, ypr, pm, height, width):
    """(k, H*W) winner colour bins of the cloud rendered at k poses."""
    cam = transform_cloud(_pose_batch(trans, ypr), xyz)
    keys = attr_min_keys(cam, rgb_bins, _ATTR_BITS, (height, width), pm)
    return attr_min_decode(keys, _ATTR_BITS)


def hist_scores_core(img, xyz, rgb, trans, ypr, pm, num_split_h: int,
                     num_split_w: int, chunk: int) -> torch.Tensor:
    """Histogram-trim score per candidate (higher is better) from a live
    splat; ``chunk`` candidates are splatted at a time, then one batched
    block histogram scores them all."""
    H, W, _ = img.shape
    q = _query_side(img, num_split_h, num_split_w)
    rgb_bins = _point_bins(rgb, _NB)
    pbin = torch.cat([
        _splat_bins(xyz, rgb_bins, trans[c:c + chunk], ypr[c:c + chunk], pm,
                    H, W)
        for c in range(0, trans.shape[0], chunk)
    ])
    return _score_from_pbin(pbin, q)


def trim_by_hist(img, xyz, rgb, trans, rot, num_input: int, num_split_h: int,
                 num_split_w: int, point_mask=None):
    """The num_input candidates with the highest histogram score (stable
    argsort, taken from the top: among ties the higher index first)."""
    scores = hist_scores_core(img, xyz, rgb, trans, rot, point_mask,
                              num_split_h, num_split_w, chunk=8)
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
