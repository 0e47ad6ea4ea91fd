"""The one-program room probe (port of piccolo_tpu/probe.py).

Serving's ``room = "auto"`` must tell which resident room a panorama
belongs to.  The discriminator is a descended loss (a stage-1 grid minimum
does not separate rooms made by one generator), and a full query per room
is expensive.  The batched probe ranks every resident room at once:

  * clouds padded to the residents' largest room (validity masks);
  * each room's real translation rows strided down to a pair budget
    (a probe ranks, it does not localize), padded to a common row count;
  * the rotation grid is config-derived, hence shared;
  * per room, a truncated stage-1 loss table at the init resolution
    (``init.refine.score_pose_grid``) and its stable top ``num_starts``;
  * ONE descent of R x ``num_starts`` starts on the shared init table: the
    poses lead with (R, S) against the (R, N, 3) cloud stack, which is the
    JAX package's ``vmap`` over rooms, and on the card it is one captured
    graph (``solver``);
  * per room the minimum final loss, fetched as one (R,) vector.

No reference counterpart (the reference assumes the query's room is known,
localize.py:152-165).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .device import as_tensor, resolve_device
from .init.refine import _host, score_pose_grid
from .ops.sampling import pack_bilinear_blocks
from .solver import StepInputs, StepStatics, descend_packed

__all__ = ["probe_rooms", "ProbeState", "build_probe_state"]


def probe_rooms(img_init, xyz, rgb, point_mask, trans, trans_valid, rot, lo,
                hi, *, num_starts: int = 6, num_iter: int = 30,
                lr: float = 0.1, patience: int = 5, factor: float = 0.8,
                wrap: bool = False, device="cuda",
                _eager: bool = False) -> torch.Tensor:
    """Probe losses (R,): per room, the best short-descended loss.

    Args:
      img_init: (H, W, 3) init-resolution query image (the probe never sees
        the main image).
      xyz / rgb: (R, N, 3) padded clouds; point_mask (R, N) bool.
      trans: (R, T, 3) padded probe translation grids; trans_valid (R, T).
      rot: (K, 3) shared rotation grid.  lo / hi: (R, 3) clamp boxes.
      num_starts / num_iter / lr / patience / factor: the short descent.
    Every stage runs at the init resolution: the room's loss table over its
    probe grid x ``rot`` (padding rows +inf), its ``num_starts`` best pairs
    descend ``num_iter`` steps with the reference loss + Adam + plateau +
    clamp transition, and the room reports the minimum final loss (+inf
    when nothing valid: the caller's fallback handles empty rooms).
    ``_eager``: as ``solver.descend_starts``.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    img = as_tensor(img_init, dev, f32)
    xyz = as_tensor(xyz, dev, f32)
    rgb = as_tensor(rgb, dev, f32)
    pm = as_tensor(point_mask, dev, torch.bool)
    trans = as_tensor(trans, dev, f32)
    valid = as_tensor(trans_valid, dev, torch.bool)
    rot = as_tensor(rot, dev, f32)
    lo = as_tensor(lo, dev, f32)
    hi = as_tensor(hi, dev, f32)
    H, W, _ = img.shape
    K = rot.shape[0]
    starts_t, starts_r, oks = [], [], []
    for r in range(xyz.shape[0]):
        scores = score_pose_grid(img, xyz[r], rgb[r], trans[r], rot, pm[r],
                                 valid=valid[r], wrap=wrap)
        # lax.top_k of the negated scores: the lower index first on ties
        top = torch.sort(scores, stable=True)
        idx = top.indices[:num_starts]
        starts_t.append(trans[r][idx // K])
        starts_r.append(rot[idx % K])
        oks.append(torch.isfinite(top.values[:num_starts]))
    x = StepInputs(pack_bilinear_blocks(img, wrap=wrap), xyz, rgb, pm,
                   lo[:, None, :], hi[:, None, :], None)
    s = StepStatics(H, W, int(patience), float(factor), bool(wrap))
    _, losses, _, _ = descend_packed(x, s, torch.stack(starts_t),
                                     torch.stack(starts_r), num_iter, lr,
                                     _eager=_eager)
    ok = torch.stack(oks) & torch.isfinite(losses)
    return torch.where(ok, losses, torch.full_like(losses, np.inf)).amin(-1)


class ProbeState:
    """The batched tensors of :func:`probe_rooms` over a resident set.

    Rebuilt whenever the resident set changes (padding and stacking of host
    arrays the room caches already hold).  Clouds pad to the residents'
    largest and probe grids to the largest subsampled row count rounded up
    to a multiple of 8, so one more room of a similar size rarely changes
    the descent's shape key.
    """

    def __init__(self, names, xyz, rgb, point_mask, trans, trans_valid, rot,
                 lo, hi):
        self.names: Tuple[str, ...] = tuple(names)
        self.xyz = xyz
        self.rgb = rgb
        self.point_mask = point_mask
        self.trans = trans
        self.trans_valid = trans_valid
        self.rot = rot
        self.lo = lo
        self.hi = hi

    def losses(self, img_init, **kw) -> np.ndarray:
        """Run the batched probe; returns the (R,) losses on the host (one
        copy)."""
        return probe_rooms(
            img_init, self.xyz, self.rgb, self.point_mask, self.trans,
            self.trans_valid, self.rot, self.lo, self.hi,
            device=self.xyz.device, **kw,
        ).cpu().numpy()


def _subsample_rows(trans: np.ndarray, n_rot: int, max_pairs: int):
    """Every k-th real translation row so that rows * n_rot <= max_pairs
    (at least one row)."""
    n = trans.shape[0]
    budget = max(1, int(max_pairs) // max(1, int(n_rot)))
    stride = -(-n // budget)  # ceil
    return trans[::stride]


def build_probe_state(rooms, rot, *, max_pairs: int = 512,
                      device="cuda") -> ProbeState:
    """Batch the resident rooms' probe inputs into one padded stack.

    Args:
      rooms: iterable of ``(name, cache)`` with a serving or harness room
        dict (``xyz_np``/``rgb_np`` host arrays, ``grids`` with the full
        candidate grid and ``n_trans``, ``lo``/``hi``).
      rot: the shared (K, 3) rotation grid (config-derived, identical
        across rooms).
      max_pairs: per-room stage-1 pair budget: each room's real translation
        rows are strided down so that rows x len(rot) fits it.
      device: where the stacked tensors live (the card unless ``"cpu"``).
    """
    rot = _host(rot).astype(np.float32)
    names, clouds, grids, boxes = [], [], [], []
    for name, cache in rooms:
        names.append(name)
        clouds.append((np.asarray(cache["xyz_np"], np.float32),
                       np.asarray(cache["rgb_np"], np.float32)))
        g = cache["grids"]
        real = _host(g.trans)[:g.n_trans].astype(np.float32)
        grids.append(_subsample_rows(real, rot.shape[0], max_pairs))
        boxes.append((_host(cache["lo"]).astype(np.float32).reshape(3),
                       _host(cache["hi"]).astype(np.float32).reshape(3)))

    n_max = max(x.shape[0] for x, _ in clouds)
    t_max = max(t.shape[0] for t in grids)
    t_max += (-t_max) % 8  # coarse bucket: stable shapes across sets
    R = len(names)
    xyz = np.zeros((R, n_max, 3), np.float32)
    rgb = np.zeros((R, n_max, 3), np.float32)
    pm = np.zeros((R, n_max), bool)
    trans = np.zeros((R, t_max, 3), np.float32)
    valid = np.zeros((R, t_max), bool)
    lo = np.zeros((R, 3), np.float32)
    hi = np.zeros((R, 3), np.float32)
    for i, ((x, c), t, (l, h)) in enumerate(zip(clouds, grids, boxes)):
        xyz[i, : x.shape[0]] = x
        rgb[i, : c.shape[0]] = c
        pm[i, : x.shape[0]] = True
        trans[i, : t.shape[0]] = t
        valid[i, : t.shape[0]] = True
        lo[i], hi[i] = l, h

    dev = resolve_device(device)
    return ProbeState(names, *(torch.as_tensor(a, device=dev) for a in (
        xyz, rgb, pm, trans, valid, rot, lo, hi)))
