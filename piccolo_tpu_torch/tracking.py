"""Video-rate sequential localization (port of piccolo_tpu/tracking.py).

Consecutive video frames are centimetres apart, so a descent warm-started
from the previous frame's pose needs no candidate search and a fraction of
the iterations.  An opt-in extension with no reference counterpart:

  * :func:`track_step`: one warm-started descent (``solver.descend`` with a
    single start), stateless;
  * :func:`track_step_prepped_fetched`: the same from a uint8 frame, with
    the frame's colour prep (``match_color``, ``sharpen_color``) on the
    device from the room's precomputed colour state;
  * :class:`Tracker`: per-sequence state, a rolling window of accepted
    losses (:class:`DivergenceGate`) and recovery through an injected
    ``recover`` callable (typically a full ``localize_query``).

  * :func:`track_steps_batched`: K streams' frames of one room as one
    K-start descent (one graph on the card), one packed (K, 16) copy.

Results come to the host as ONE packed 16-float copy (t, ypr, rot, loss),
inside a ``service.fetch`` span; each entry point's table build and descent
run inside ``localize.stage3_descent`` (``utils.profiling.span``), the span
a full query's descent opens.
Entry points run on the card unless the caller passes ``device="cpu"``.
``exec_cache_dir`` loads the process's kernel libraries and JPEG codec from
the executable cache (``utils.exec_cache``) before the first step.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .color import SharpenTensors, color_match_device, color_mod_device
from .config import cfg_get
from .convert import cdf_from_numpy, sharpen_state_from_numpy
from .device import as_tensor, resolve_device
from .loss import pose_rotation
from .ops.rotation import rot_from_ypr
from .ops.sampling import resolve_descent_table
from .solver import (
    SolveResult,
    StepInputs,
    StepStatics,
    _packed_table,
    descend,
    descend_packed,
)
from .utils import exec_cache
from .utils.profiling import span

__all__ = [
    "TrackResult",
    "track_step",
    "track_step_fetched",
    "track_step_prepped_fetched",
    "track_steps_batched",
    "track_kwargs",
    "DivergenceGate",
    "Tracker",
    "ypr_from_rot",
]


def ypr_from_rot(rot: np.ndarray) -> np.ndarray:
    """Euler angles (yaw, pitch, roll) of R = RZ(yaw) @ RY(pitch) @ RX(roll).

    Inverse of ``ops.rotation.rot_from_ypr``; continues tracking from a
    full-pipeline answer, which reports only the rotation matrix.
    Gimbal-degenerate poses (|pitch| = pi/2) resolve with roll = 0.
    """
    R = np.asarray(rot, np.float64)
    pitch = -np.arcsin(np.clip(R[2, 0], -1.0, 1.0))
    if abs(R[2, 0]) < 1.0 - 1e-9:
        yaw = np.arctan2(R[1, 0], R[0, 0])
        roll = np.arctan2(R[2, 1], R[2, 2])
    else:  # cos(pitch) = 0: yaw and roll are coupled; put it all in yaw
        yaw = np.arctan2(-R[0, 1], R[1, 1])
        roll = 0.0
    return np.array([yaw, pitch, roll], np.float32)


class TrackResult(NamedTuple):
    t: np.ndarray          # (3,) translation
    ypr: np.ndarray        # (3,) yaw/pitch/roll
    rot: np.ndarray        # (3, 3)
    loss: float            # final sampling loss
    recovered: bool        # True when this frame re-ran the full pipeline
    lost: bool             # True when divergence was detected but no
                           # recovery callable was available


def _use_exec_cache(exec_cache_dir, device) -> None:
    """``exec_cache_dir``: this process's kernel libraries and JPEG codec
    from the executable cache (``utils.exec_cache.warm``: once a process
    and directory, then a dictionary lookup)."""
    if exec_cache_dir:
        exec_cache.warm(exec_cache_dir, device)


def track_step(img, xyz, rgb, prev_t, prev_ypr, lo, hi, point_mask=None, *,
               num_iter: int = 30, lr: float = 0.03, patience: int = 3,
               factor: float = 0.5, table_dtype: str = "auto",
               wrap: bool = False, exec_cache_dir=None,
               device="cuda") -> SolveResult:
    """One warm-started descent from the previous frame's pose.

    :func:`solver.descend` with a single start; the tracking defaults (30
    iterations, lr 0.03 with a fast 0.5x plateau) suit centimetre-scale
    inter-frame motion.  Use the full budget (100, 0.1, 5, 0.8) when frames
    may be far apart.
    """
    _use_exec_cache(exec_cache_dir, device)
    with span("localize.stage3_descent"):
        return descend(
            img, xyz, rgb,
            np.asarray(prev_t, np.float32).reshape(1, 3),
            np.asarray(prev_ypr, np.float32).reshape(1, 3),
            lo, hi, point_mask,
            num_iter=num_iter, lr=lr, patience=patience, factor=factor,
            masked=point_mask is not None, table_dtype=table_dtype,
            wrap=wrap, device=device,
        )


def _unpack_fetched(res: SolveResult):
    """A single-start result through ONE copy to the host: ``(t (3,),
    ypr (3,), rot (3, 3), loss)``."""
    with span("service.fetch"):
        flat = torch.cat([res.t[0], res.ypr[0], res.rot[0].reshape(-1),
                          res.loss[0:1]]).cpu().numpy()
    return flat[0:3], flat[3:6], flat[6:15].reshape(3, 3), float(flat[15])


def track_step_fetched(img, xyz, rgb, prev_t, prev_ypr, lo, hi,
                       point_mask=None, **kw):
    """:func:`track_step` and the one-copy result: shared by
    :class:`Tracker`, :func:`track_step_prepped_fetched`, the serving track
    path and the CLI loop."""
    return _unpack_fetched(track_step(img, xyz, rgb, prev_t, prev_ypr, lo,
                                      hi, point_mask, **kw))


def upload_frame(img_u8, dev):
    """(H, W, 3) uint8 frame (numpy, or a tensor on the device) -> f32 in
    [0, 1] on ``dev``, with numpy's bits."""
    u8 = as_tensor(img_u8, dev, torch.uint8)
    # a true division, as numpy's: the card divides by a Python scalar as
    # a multiply by its reciprocal, an ulp off at 126 of the 256 levels
    return u8.to(torch.float32) / torch.full((), 255.0, device=dev)


def colour_frame(img, cdf, sharpen, rgb):
    """f32 frame in [0, 1] on its device -> optional CDF match (then the
    batch path's uint8 requantisation) -> optional sharpen, which rebinds
    the cloud colours; returns (img, rgb)."""
    dev = img.device
    if cdf is not None:
        values, quant = (cdf if isinstance(cdf[0], torch.Tensor)
                         else cdf_from_numpy(cdf, dev))
        img = color_match_device(img, values.to(dev), quant.to(dev))
        # the batch path requantises the matched image to uint8
        # (harness finish_omniscenes_images; reference localize.py:403-405)
        img = torch.floor(img * 255.0) / 255.0
    if sharpen is not None:
        if not isinstance(sharpen, SharpenTensors):  # numpy SharpenState
            sharpen = sharpen_state_from_numpy(sharpen, dev)
        # the host applies color_mod to the float matched image; its
        # trunc-to-uint8 sees the integers of the requantised image above
        img, rgb = color_mod_device(img, sharpen)
    return img, rgb


def track_step_prepped_fetched(img_u8, xyz, rgb, prev_t, prev_ypr, lo, hi,
                               point_mask=None, *, cdf=None, sharpen=None,
                               num_iter: int = 30, lr: float = 0.03,
                               patience: int = 3, factor: float = 0.5,
                               table_dtype: str = "auto", wrap: bool = False,
                               exec_cache_dir=None, device="cuda"):
    """Tracked-frame fast path: the uint8 panorama goes to the device, its
    per-frame colour prep runs there, then the one-start descent; one copy
    back.

    Args:
      img_u8: (H, W, 3) uint8 frame (numpy, or a tensor on the device).
      cdf: None, or the room's ``(values, quant)`` from
        ``color.cloud_color_cdf`` (numpy or tensors): the ``match_color``
        semantics.
      sharpen: None, or the room's ``color.cloud_sharpen_state`` (numpy, or
        ``convert.sharpen_state_from_numpy``'s tensors): the
        ``sharpen_color`` semantics, rebinding the frame AND the cloud
        colours; applied after the match, in host-prep order.
      Everything else: as :func:`track_step`.
    Returns ``(t (3,), ypr (3,), rot (3, 3), loss)`` on the host.
    """
    dev = resolve_device(device)
    _use_exec_cache(exec_cache_dir, dev)
    img, rgb = colour_frame(upload_frame(img_u8, dev), cdf, sharpen, rgb)
    return track_step_fetched(
        img, xyz, rgb, prev_t, prev_ypr, lo, hi, point_mask,
        num_iter=num_iter, lr=lr, patience=patience, factor=factor,
        table_dtype=table_dtype, wrap=wrap, device=dev)


def track_steps_batched(imgs, xyz, rgb, prev_ts, prev_yprs, lo, hi,
                        point_mask=None, *, num_iter: int = 30,
                        lr: float = 0.03, patience: int = 3,
                        factor: float = 0.5, table_dtype: str = "auto",
                        wrap: bool = False, exec_cache_dir=None,
                        device="cuda", _eager: bool = False):
    """K streams' tracked frames against one room as ONE descent: the JAX
    package's ``vmap`` of the tracked step (``_track_batch``), written as K
    starts on K stacked tables.

    Each frame's packed table is stacked into one (K * rows, 12) table and
    start k samples its own through a row offset
    (``ops.sampling.bilinear_sample_packed``); the cloud, mask and box are
    shared.  On the card the K-start descent is one captured graph (K = 1
    shares :func:`track_step`'s), and the K results come back in ONE packed
    (K, 16) copy.  Every stream's loss depends only on its own pose and
    table, so a stream's answer is its own :func:`track_step`'s up to the
    order in which a batch-shaped reduction adds the same terms.

    Args:
      imgs: (K, H, W, 3) float frames in [0, 1], one per stream, one shape.
      prev_ts / prev_yprs: (K, 3) warm-start poses.
      Everything else: as :func:`track_step` (shared across streams).
    Returns:
      a list of K ``(t (3,), ypr (3,), rot (3, 3), loss)`` host tuples.
    """
    dev = resolve_device(device)
    _use_exec_cache(exec_cache_dir, dev)
    imgs = as_tensor(imgs, dev, torch.float32)
    K, H, W, _ = imgs.shape
    dtype = resolve_descent_table(table_dtype, H, W, dev)
    with span("localize.stage3_descent"):
        blocks = torch.cat([_packed_table(img, dtype, wrap) for img in imgs])
        offset = None
        if K > 1:
            offset = (torch.arange(K, dtype=torch.int32, device=dev)
                      * ((H + 1) * (W + 1)))[:, None]
        x = StepInputs(blocks, as_tensor(xyz, dev, torch.float32),
                       as_tensor(rgb, dev, torch.float32),
                       None if point_mask is None
                       else as_tensor(point_mask, dev, torch.bool),
                       as_tensor(lo, dev, torch.float32),
                       as_tensor(hi, dev, torch.float32), offset)
        s = StepStatics(H, W, int(patience), float(factor), bool(wrap))
        params, losses, _, _ = descend_packed(
            x, s,
            as_tensor(np.asarray(prev_ts, np.float32).reshape(-1, 3), dev),
            as_tensor(np.asarray(prev_yprs, np.float32).reshape(-1, 3), dev),
            num_iter, lr, _eager=_eager)
    with span("service.fetch"):
        ypr = params.ypr()
        flat = torch.cat([params.t, ypr, pose_rotation(params).reshape(K, 9),
                          losses[:, None]], 1).cpu().numpy()
    return [(f[0:3], f[3:6], f[6:15].reshape(3, 3), float(f[15]))
            for f in flat]


def track_kwargs(cfg) -> dict:
    """The per-frame descent budget from the config (track_num_iter, lr,
    patience, factor, descent_table, seam_wrap): one resolution point for
    the CLI loop and serving."""
    return dict(
        num_iter=cfg_get(cfg, "track_num_iter", 30),
        lr=cfg_get(cfg, "track_lr", 0.03),
        patience=cfg_get(cfg, "track_patience", 3),
        factor=cfg_get(cfg, "track_factor", 0.5),
        table_dtype=cfg_get(cfg, "descent_table", "auto"),
        wrap=cfg_get(cfg, "seam_wrap", False),
    )


class DivergenceGate:
    """Rolling-median divergence policy, shared by Tracker and the CLI loop.

    A frame diverges when its loss is non-finite, or when ``window``
    losses have been accepted and the new loss exceeds ``ratio`` x their
    rolling median (the sampling loss is scene-scaled, so the threshold is
    relative).  Non-finite losses are never accepted into the window: one
    NaN would disable every later comparison.
    """

    def __init__(self, window: int = 8, ratio: float = 3.0):
        self._losses: deque = deque(maxlen=int(window))
        self._ratio = float(ratio)

    def diverged(self, loss: float) -> bool:
        return not np.isfinite(loss) or (
            len(self._losses) == self._losses.maxlen
            and loss > self._ratio * float(np.median(self._losses))
        )

    def accept(self, loss: float) -> None:
        if np.isfinite(loss):
            self._losses.append(float(loss))

    def reset(self) -> None:
        self._losses.clear()


def _rot_of(ypr) -> np.ndarray:
    return rot_from_ypr(torch.as_tensor(np.asarray(ypr, np.float32))).numpy()


class Tracker:
    """Sequential localizer over one room: warm descent and recovery.

    Args:
      xyz/rgb/point_mask: the room cloud (padded, with its validity mask).
      lo/hi: the translation clamp box (``ops.quantile.cloud_bounds``).
      init_t/init_ypr: the first frame's pose, typically from one full
        ``localize_query``.
      recover: optional ``(img) -> (t, ypr)`` running the full pipeline;
        called when a frame diverges.
      recover_ratio / window: the :class:`DivergenceGate`.
      num_iter/lr/patience/factor/table_dtype/wrap: the per-frame descent
        budget (see :func:`track_step`).
      device: where the descents run (the card unless ``"cpu"``).
    """

    def __init__(self, xyz, rgb, lo, hi, init_t, init_ypr, point_mask=None,
                 *, recover: Optional[Callable] = None,
                 recover_ratio: float = 3.0, window: int = 8,
                 num_iter: int = 30, lr: float = 0.03, patience: int = 3,
                 factor: float = 0.5, table_dtype: str = "auto",
                 wrap: bool = False, exec_cache_dir=None, device="cuda"):
        dev = resolve_device(device)
        _use_exec_cache(exec_cache_dir, dev)
        self._cloud = (
            as_tensor(xyz, dev, torch.float32),
            as_tensor(rgb, dev, torch.float32),
            None if point_mask is None else as_tensor(point_mask, dev,
                                                      torch.bool),
        )
        self._box = (as_tensor(lo, dev, torch.float32),
                     as_tensor(hi, dev, torch.float32))
        self._pose = (
            np.asarray(init_t, np.float32).reshape(3),
            np.asarray(init_ypr, np.float32).reshape(3),
        )
        self._recover = recover
        self._gate = DivergenceGate(window=window, ratio=recover_ratio)
        self._kw = dict(num_iter=num_iter, lr=lr, patience=patience,
                        factor=factor, table_dtype=table_dtype, wrap=wrap,
                        device=dev)

    @property
    def pose(self) -> Tuple[np.ndarray, np.ndarray]:
        """The current (t, ypr) estimate."""
        return self._pose

    def _descend(self, img):
        xyz, rgb, mask = self._cloud
        return track_step_fetched(img, xyz, rgb, self._pose[0],
                                  self._pose[1], self._box[0], self._box[1],
                                  mask, **self._kw)

    def update(self, img) -> TrackResult:
        """Track one frame; returns the accepted pose for it."""
        t, ypr, rot, loss = self._descend(img)
        recovered = lost = False
        if self._gate.diverged(loss):
            if self._recover is None:
                lost = True
                if not np.isfinite(loss):
                    # a NaN/inf pose is unusable even as a suspect result:
                    # hold the previous pose instead of poisoning the next
                    # frame's warm start
                    t, ypr = self._pose
                    rot = _rot_of(ypr)
            else:
                rt, rypr = self._recover(img)
                self._pose = (
                    np.asarray(rt, np.float32).reshape(3),
                    np.asarray(rypr, np.float32).reshape(3),
                )
                t, ypr, rot, loss = self._descend(img)
                if not np.isfinite(loss):
                    # refinement from the fresh seed blew up: answer with
                    # the recovery pose itself
                    t, ypr = self._pose
                    rot = _rot_of(ypr)
                self._gate.reset()  # the loss regime may have shifted
                recovered = True
        self._pose = (t, ypr)
        if not lost:
            self._gate.accept(loss)
        return TrackResult(t=t, ypr=ypr, rot=rot, loss=loss,
                           recovered=recovered, lost=lost)
