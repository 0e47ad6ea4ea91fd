"""Stanford2D-3D-S and OmniScenes evaluation harnesses (port of
piccolo_tpu/harness/localize.py, single device).

Per query: file discovery, cloud loading on room change, colour
preprocessing, the out-of-room gate, the fused query
(``pipeline.localize_query``) or the staged path (``init.make_input`` then
``solver.descend``), error metrics, accuracy accounting and the CSV /
TensorBoard / image artifacts, with the reference's schemas.  The staged
path runs where the JAX package takes it: ``fused = False``,
``sample_rate_for_init``; on the run's own device.  ``descent_prune_*``
and ``descent_multires_*`` reach the descent on both paths.

Stage 1 runs through the JAX package's plan admission ladder
(``_slab_admission``): slab off, or the f32 plan, demoted to the compact
plan, the q8 plan, a partial q8 plan with a gather-engine tail, or the
gather engine, by the plan-memory budget and the per-query cost model
``slab_worthwhile``, each with the room's device's own values (on the
card the H100's, on the CPU the JAX package's).  Plans are built once per
room and init-image size, in line by default.  ``slab_background_build =
True`` builds them on a thread while the room's first queries run the
gather engine, and
``slab_plan_cache = True`` persists them to a disk cache that the JAX
package shares.  Both are off by default, unlike in the JAX package: on
the H100 a plan builds faster than it loads from the disk (PERF.md).  A
plan build that fails demotes stage 1 to the gather engine; the kernels'
own build and launch errors are never caught.

``tracking = True`` on the OmniScenes CLI warm-starts each video frame
after the first from the previous frame's pose (``tracking.py``); tracked
frames whose colour prep can run on the device take the uint8 frame there
(``tracking.track_step_prepped_fetched``).

``n_devices`` shards each fused query over a ('cand', 'point') mesh
(``parallel``; ``mesh_cand`` / ``mesh_point`` factor it): on the card the
count is of visible cards, with ``--device cpu`` of logical shards on the
CPU.  The room lives on the mesh's lead device, and its cloud, slab plan
and HistPlan are laid out on the mesh once per room.

``profile_dir`` writes one ``torch.profiler`` trace a query
(``utils.maybe_trace``); ``exec_cache_dir`` builds or loads the process's
kernel libraries and JPEG codec from the executable cache before the first
query (``utils.exec_cache``) and prints what it found; ``debug_nans``
turns on anomaly detection (``utils.enable_nan_debug``).

The CPU rule of the JAX package (``auto`` plans off on the CPU backend)
becomes: ``auto`` plans are off when the room lives on the CPU.
"""

from __future__ import annotations

import collections
import glob as globlib
import os
import random
import threading
import time
import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from .. import data as data_mod
from ..color import color_match, color_mod
from ..config import cfg_get
from ..convert import cloud_from_numpy
from ..device import resolve_device
from ..init.candidates import generate_rot_points, generate_trans_points
from ..init.refine import SUPPORTED_CRITERIA, check_criterion, make_input
from ..ops.pano import render_pano
from ..ops.quantile import cloud_bounds, outside_box
from ..ops.rotation import rot_from_ypr
from ..pipeline import localize_query
from ..solver import descend, descent_note
from ..utils import exec_cache
from ..utils.profiling import count, enable_nan_debug, maybe_trace, span
from .imaging import imread_rgb, resize
from .metrics import (
    OMNISCENES_R_THRESH_DEG,
    OMNISCENES_T_THRESH,
    STANFORD_R_THRESH_DEG,
    STANFORD_T_THRESH,
    AccuracyTracker,
    rotation_error_deg,
    translation_error,
)
from .outputs import (
    OMNISCENES_COLUMNS,
    STANFORD_COLUMNS,
    CsvSummary,
    ScalarSummaries,
    fmt_array,
    save_gif,
    save_result_image,
)
from .prefetch import AsyncWriter, Prefetcher

__all__ = ["localize_stanford", "localize_omniscenes", "get_init_dict",
           "prepare_stanford_images", "prepare_omniscenes_images",
           "finish_omniscenes_images", "resize_ablate_omniscenes",
           "synth_ablate"]

# One slab-plan build at a time, process-wide: an orphaned background build
# of the previous room keeps its memory until it finishes, and two near-cap
# plans must never be resident at once.
_PLAN_BUILD_GATE = threading.Semaphore(1)


def get_init_dict(cfg) -> Dict:
    """Materialise the init hyperparameters (reference localize.py:18-73)."""
    return dict(
        xy_only=cfg_get(cfg, "xy_only", True),
        num_trans=cfg_get(cfg, "num_trans", 50),
        yaw_only=cfg_get(cfg, "yaw_only", True),
        num_yaw=cfg_get(cfg, "num_yaw", 4),
        num_pitch=cfg_get(cfg, "num_pitch", 0),
        num_roll=cfg_get(cfg, "num_roll", 0),
        max_yaw=cfg_get(cfg, "max_yaw", 2 * np.pi),
        min_yaw=cfg_get(cfg, "min_yaw", 0),
        max_pitch=cfg_get(cfg, "max_pitch", 2 * np.pi),
        min_pitch=cfg_get(cfg, "min_pitch", 0),
        max_roll=cfg_get(cfg, "max_roll", 2 * np.pi),
        min_roll=cfg_get(cfg, "min_roll", 0),
        x_max=cfg_get(cfg, "x_max"),
        x_min=cfg_get(cfg, "x_min"),
        y_max=cfg_get(cfg, "y_max"),
        y_min=cfg_get(cfg, "y_min"),
        z_max=cfg_get(cfg, "z_max"),
        z_min=cfg_get(cfg, "z_min"),
        z_prior=cfg_get(cfg, "z_prior"),
        dataset=cfg.dataset,
        sample_rate_for_init=cfg_get(cfg, "sample_rate_for_init"),
        trans_init_mode=cfg_get(cfg, "trans_init_mode", "quantile"),
        num_split_h=cfg_get(cfg, "num_split_h", 2),
        num_split_w=cfg_get(cfg, "num_split_w", 4),
    )


# ---------------------------------------------------------------------------
# helpers


def _bucket(n: int, base: int = 4096) -> int:
    """Smallest bucket >= n from {base * 2^k, base * 3*2^(k-1)}."""
    b = base
    while b < n:
        if b * 3 // 2 >= n:
            return b * 3 // 2
        b *= 2
    return b


def _pad_cloud(xyz: np.ndarray, rgb: np.ndarray,
               device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cloud padded with zeros to its bucket, plus the validity mask, as
    tensors on ``device``."""
    n = xyz.shape[0]
    pad = _bucket(n) - n
    xyz_p = np.concatenate([xyz, np.zeros((pad, 3), xyz.dtype)])
    rgb_p = np.concatenate([rgb, np.zeros((pad, 3), rgb.dtype)])
    mask = np.arange(n + pad) < n
    return cloud_from_numpy(xyz_p, rgb_p, mask, device)


def _order_bounds(xyz: np.ndarray, q: float) -> Tuple[np.ndarray, np.ndarray]:
    """Order-quantile clamp box on the host from the unpadded cloud."""
    lo, hi = cloud_bounds(xyz, q)
    return lo.astype(np.float32), hi.astype(np.float32)


# Out-of-room gate against the precomputed per-room box (strict inequalities)
_outside_bounds = outside_box


def _pad_rgb(rgb_mod: np.ndarray, padded_len: int, device) -> torch.Tensor:
    """Per-query modified colours padded to the cloud's bucket, on
    ``device``."""
    pad = padded_len - rgb_mod.shape[0]
    if pad:
        rgb_mod = np.concatenate([rgb_mod, np.zeros((pad, 3), rgb_mod.dtype)])
    return torch.as_tensor(np.asarray(rgb_mod, np.float32), device=device)


def _result_render(t, R, xyz, rgb, mask, resolution) -> np.ndarray:
    """uint8 render of the cloud at the pose (t, R): X_cam = R (X - t)."""
    dev = xyz.device
    t = torch.as_tensor(np.asarray(t, np.float32).reshape(3), device=dev)
    R = torch.as_tensor(np.asarray(R, np.float32), device=dev)
    # elementwise multiply-adds: full f32 whatever the TF32 settings
    cam = ((xyz - t)[:, None, :] * R[None]).sum(-1)
    img = render_pano(cam, rgb, resolution, mask)
    return img.cpu().numpy().astype(np.uint8)


def _gif_frames(traj, k, xyz, rgb, mask, resolution) -> list:
    """Per-iteration frames of the winning candidate."""
    ts = traj.t[k].cpu().numpy()  # (num_iter, 3)
    ypr = torch.stack([traj.yaw[k], traj.pitch[k], traj.roll[k]], -1).cpu()
    Rs = rot_from_ypr(ypr).numpy()
    return [_result_render(ts[i], Rs[i], xyz, rgb, mask, resolution)
            for i in range(ts.shape[0])]


def prepare_stanford_images(cfg, orig: np.ndarray, room: Dict):
    """Per-query Stanford image preprocessing (reference localize.py:
    167-179): init-resolution resize, ``sharpen_color`` on the INIT image
    only (the descent runs on the unmodified main image), main resize.
    ``orig`` is the decoded (H, W, 3) uint8 RGB panorama.

    Returns ``(img_init, img_main, rgb_used, prep_timed)``; ``prep_timed``
    is the main-resize wall time, the only prep the reference's per-query
    timer covers (localize.py:208-223).
    """
    init_dh = cfg_get(cfg, "init_downsample_h", 1)
    init_dw = cfg_get(cfg, "init_downsample_w", 1)
    main_dh = cfg_get(cfg, "main_downsample_h", 1)
    main_dw = cfg_get(cfg, "main_downsample_w", 1)
    H0, W0 = orig.shape[:2]
    with span("service.prep.resize"):
        img_init = resize(orig, (W0 // init_dw, H0 // init_dh)).astype(np.float32) / 255.0
    rgb_used = room["rgb"]
    if cfg_get(cfg, "sharpen_color", False):
        with span("service.prep.color"):
            img_init, rgb_mod = color_mod(
                img_init, room["rgb_np"], cfg_get(cfg, "num_bins", 256)
            )
            rgb_used = _pad_rgb(rgb_mod, int(room["mask"].shape[0]),
                                room["device"])
    with span("service.prep.resize"):
        rt0 = time.time()
        img_main = resize(orig, (W0 // main_dw, H0 // main_dh)).astype(np.float32) / 255.0
        prep_timed = time.time() - rt0
    return img_init, img_main, rgb_used, prep_timed


def synth_ablate(orig: np.ndarray, const=None, gamma=None, wb=None):
    """The synthetic illumination ablations (reference localize.py:384-393)
    on a uint8 image: brightness divisor, gamma curve, per-channel white-
    balance gains (gains above 1 saturate at 255 instead of wrapping)."""
    if const is not None:
        orig = (orig // const).astype(np.uint8)
    if gamma is not None:
        orig = (((orig / 255.0) ** gamma) * 255).astype(np.uint8)
    if wb is not None:
        scaled = orig.astype(np.float64)
        scaled[..., 0] *= wb[0]
        scaled[..., 1] *= wb[1]
        scaled[..., 2] *= wb[2]
        orig = np.clip(scaled, 0, 255).astype(np.uint8)
    return orig


def resize_ablate_omniscenes(cfg, raw: np.ndarray) -> np.ndarray:
    """The uint8 head of the OmniScenes prep: the 2048x1024 resize
    (reference localize.py:381) and the synthetic ablations."""
    orig = resize(raw, (2048, 1024))
    return synth_ablate(
        orig,
        const=cfg_get(cfg, "synth_const"),
        gamma=cfg_get(cfg, "synth_gamma"),
        wb=((cfg.synth_r, cfg.synth_g, cfg.synth_b)
            if cfg_get(cfg, "synth_wb") else None),
    )


def prepare_omniscenes_images(cfg, raw: np.ndarray, room: Dict):
    """Per-query OmniScenes image preprocessing (reference localize.py:
    380-410) from the decoded native-size uint8 RGB panorama ``raw``.

    Returns ``(orig, img_init, img_main, rgb_used, prep_timed)``: ``orig``
    is the colour-processed uint8 image the starting-point dumps render
    against, ``prep_timed`` the main-resize wall time."""
    return finish_omniscenes_images(cfg, resize_ablate_omniscenes(cfg, raw),
                                    room)


def finish_omniscenes_images(cfg, orig: np.ndarray, room: Dict):
    """The colour and resize tail of :func:`prepare_omniscenes_images`:
    ``match_color`` then ``sharpen_color`` at 2048x1024, each followed by
    the reference's uint8 requantisation, then the init resize (the
    reference halves ``init_downsample`` "to match resolution with
    stanford", localize.py:349-350) and the main resize, which the
    reference's per-query timer covers."""
    rgb_used = room["rgb"]
    with span("service.prep.color"):
        mod_img = orig.astype(np.float32) / 255.0
        if cfg_get(cfg, "match_color", False):
            mod_img = color_match(mod_img, room["rgb_np"])
            orig = (mod_img * 255).astype(np.uint8)
        if cfg_get(cfg, "sharpen_color", False):
            mod_img, rgb_mod = color_mod(mod_img, room["rgb_np"],
                                         cfg_get(cfg, "num_bins", 256))
            orig = (mod_img * 255).astype(np.uint8)
            rgb_used = _pad_rgb(rgb_mod, int(room["mask"].shape[0]),
                                room["device"])
    init_dh = max(cfg_get(cfg, "init_downsample_h", 1) // 2, 1)
    init_dw = max(cfg_get(cfg, "init_downsample_w", 1) // 2, 1)
    main_dh = cfg_get(cfg, "main_downsample_h", 1)
    main_dw = cfg_get(cfg, "main_downsample_w", 1)
    H0, W0 = orig.shape[:2]
    with span("service.prep.resize"):
        img_init = resize(orig, (W0 // init_dw, H0 // init_dh)).astype(np.float32) / 255.0
        rt0 = time.time()
        img_main = resize(orig, (W0 // main_dw, H0 // main_dh)).astype(np.float32) / 255.0
        prep_timed = time.time() - rt0
    return orig, img_init, img_main, rgb_used, prep_timed


_mode_warned: set = set()


def _warn_once(key: str, msg: str) -> None:
    if key not in _mode_warned:
        _mode_warned.add(key)
        warnings.warn(msg)


def _cfg_prune(cfg, want_traj: bool = False):
    """``descent_prune_iter``/``descent_prune_keep`` as ``(prune_iter,
    prune_keep)``, or None when off.  A visualize query needs every start's
    frames, so it runs the full descent (warned once)."""
    k = int(cfg_get(cfg, "descent_prune_iter", 0) or 0)
    if k <= 0:
        return None
    m = int(cfg_get(cfg, "descent_prune_keep", 2) or 0)
    if want_traj:
        _warn_once("traj", "visualize queries run the full descent (pruned "
                   "candidates have no per-iteration frames) — "
                   "descent_prune_* ignored")
        return None
    return (k, m)


def _cfg_multires(cfg, want_traj: bool = False):
    """``descent_multires_iter``/``descent_multires_stride`` as
    ``(low_iters, stride)``, or None when off; a visualize query runs the
    full-resolution descent (warned once).  Combined with descent prune it
    raises in the solver."""
    k = int(cfg_get(cfg, "descent_multires_iter", 0) or 0)
    if k <= 0:
        return None
    s = int(cfg_get(cfg, "descent_multires_stride", 2) or 2)
    if want_traj:
        _warn_once("traj_mr", "visualize queries run the full-resolution "
                   "descent — descent_multires_* ignored")
        return None
    return (k, s)


def _use_fused(cfg, init_dict) -> bool:
    """Whether the fused query serves this config; ``fused = False`` and an
    init-only subsample (``sample_rate_for_init``) take the staged path."""
    return bool(
        cfg_get(cfg, "fused", True)
        and init_dict.get("sample_rate_for_init") is None
        and cfg_get(cfg, "criterion", "loss_histogram") in SUPPORTED_CRITERIA
    )


def _solve_query(img_main, cache, rgb_used, trans0, ypr0, cfg,
                 want_traj: bool):
    """The staged path's descent from ``make_input``'s starts on the room's
    device; returns (SolveResult, trajectory or None)."""
    out = descend(
        img_main, cache["xyz"], rgb_used, trans0, ypr0, cache["lo"],
        cache["hi"], cache["mask"],
        num_iter=cfg_get(cfg, "num_iter", 100), lr=cfg_get(cfg, "lr", 0.1),
        patience=cfg_get(cfg, "patience", 5),
        factor=cfg_get(cfg, "factor", 0.9), masked=True, trajectory=want_traj,
        table_dtype=cfg_get(cfg, "descent_table", "auto"),
        wrap=bool(cfg_get(cfg, "seam_wrap", False)),
        prune=_cfg_prune(cfg, want_traj), multires=_cfg_multires(cfg, want_traj),
        device=cache["device"],
    )
    return out if want_traj else (out, None)


def _run_staged(img_init, img_main, cache, rgb_used, cfg, init_dict,
                want_traj=False):
    """One query through the staged path; returns (result, traj, starts)
    with ``result`` a SolveResult and ``starts`` make_input's (t, ypr)."""
    trans0, rot0 = make_input(
        img_init, cache["xyz"], rgb_used, cfg_get(cfg, "num_input", 6),
        init_dict, cfg_get(cfg, "criterion", "loss_histogram"),
        cfg_get(cfg, "num_intermediate", 20), point_mask=cache["mask"],
        wrap=bool(cfg_get(cfg, "seam_wrap", False)), device=cache["device"],
    )
    res, traj = _solve_query(img_main, cache, rgb_used, trans0, rot0, cfg,
                             want_traj)
    return res, traj, (trans0, rot0)


def _localize_one(b, cache, cfg, init_dict, fused: bool, want_traj: bool,
                  mesh=None):
    """One query by the fused or the staged path: a dict with the winner
    index ``k``, its ``t``, ``R``, ``ypr`` and ``loss`` on the host, the starting
    poses ``trans0``/``rot0`` (numpy), the printed ``route`` and ``traj``
    (None unless ``want_traj``).  ``mesh`` shards the fused query."""
    if fused:
        fres, route = _run_fused(b["img_init"], b["img_main"], cache,
                                 b["rgb_used"], cfg, init_dict,
                                 cache["grids"], mesh, want_traj=want_traj)
        traj = None
        if want_traj:
            fres, traj = fres
        k = int(fres.winner)
        return dict(k=k, t=fres.t.cpu().numpy(), R=fres.rot.cpu().numpy(),
                    ypr=fres.cand_ypr[k].cpu().numpy(),
                    loss=float(fres.loss),
                    trans0=fres.start_t.cpu().numpy(),
                    rot0=fres.start_ypr.cpu().numpy(), route=route, traj=traj)
    res, traj, (trans0, rot0) = _run_staged(
        b["img_init"], b["img_main"], cache, b["rgb_used"], cfg, init_dict,
        want_traj)
    k = int(torch.argmin(res.loss))
    return dict(k=k, t=res.t[k].cpu().numpy(), R=res.rot[k].cpu().numpy(),
                ypr=res.ypr[k].cpu().numpy(), loss=float(res.loss[k]),
                trans0=trans0, rot0=rot0,
                route="staged: make_input, then descend", traj=traj)


def _check_config(cfg, init_dict) -> None:
    """Refuse, loudly, the keys the port cannot honour."""
    check_criterion(cfg_get(cfg, "criterion", "loss_histogram"))
    if cfg_get(cfg, "gravity_aligned", True) is False:
        raise NotImplementedError(
            "gravity_aligned=False needs an alignment matrix estimator; the "
            "reference's data_utils.obtain_align_matrix does not exist either "
            "(reference localize.py:156)."
        )


def _room_device(cfg, device) -> torch.device:
    """The device of the run: ``device``, or ``cuda:i`` for
    ``device_index = i`` (one process per card)."""
    dev = resolve_device(device)
    i = cfg_get(cfg, "device_index")
    if i is None:
        return dev
    if cfg_get(cfg, "n_devices") not in (None, 0, 1):
        raise ValueError(
            "device_index (pin this process to one card) and n_devices "
            "(shard each query over a mesh) are mutually exclusive")
    if dev.type != "cuda":
        raise ValueError("device_index pins the run to one card; it needs "
                         "--device cuda")
    i = int(i)
    if not 0 <= i < torch.cuda.device_count():
        raise ValueError(f"device_index={i} but only "
                         f"{torch.cuda.device_count()} devices are visible")
    return torch.device("cuda", i)


def _maybe_mesh(cfg, device: torch.device):
    """The ('cand', 'point') mesh the config asks for, or None.

    ``n_devices``: an int or ``"all"``; unset or 1 keeps the single-device
    path.  On the card it counts visible cards (beyond them it raises); on
    the CPU it counts logical shards, every one on the CPU.  ``mesh_cand``
    / ``mesh_point`` give the factorization (default: ``make_mesh``'s)."""
    n = cfg_get(cfg, "n_devices")
    if n in (None, 0, 1):
        return None
    from ..parallel import make_mesh

    if device.type == "cuda":
        visible = torch.cuda.device_count()
        n = visible if n == "all" else int(n)
        if n > visible:
            raise ValueError(
                f"n_devices={n} but only {visible} devices are visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        if n == "all":
            raise ValueError(
                "n_devices='all' counts visible cards; on the CPU give the "
                "number of logical shards")
        n = int(n)
        devices = [device] * n
    if n == 1:
        return None
    return make_mesh(cfg_get(cfg, "mesh_cand"), cfg_get(cfg, "mesh_point"),
                     devices=devices)


def _check_mesh_usable(mesh, fused: bool, vis: bool = False):
    """The mesh, or None with a warning when the config has no sharded
    path: the staged path (``sample_rate_for_init``, ``fused = False``)
    and ``visualize`` (per-iteration trajectories) run on one device."""
    if mesh is not None and (not fused or vis):
        print(
            "WARNING: n_devices requested but this config has no sharded "
            "program (sample_rate_for_init / fused = False need the staged "
            "path; visualize needs per-iteration trajectories); running "
            "single-device.\n"
        )
        return None
    return mesh


class _FusedGrids:
    """Per-room candidate grids, translations padded to a multiple of 64
    (the JAX package's shape reuse; padding rows are masked invalid)."""

    PAD_MULTIPLE = 64

    def __init__(self, xyz_np: np.ndarray, init_dict: Dict, device):
        trans = generate_trans_points(xyz_np, init_dict)
        rot = generate_rot_points(init_dict)
        self.n_trans = trans.shape[0]  # real rows (before shape padding)
        pad = (-trans.shape[0]) % self.PAD_MULTIPLE
        valid = np.ones(trans.shape[0] + pad, bool)
        if pad:
            valid[-pad:] = False
            trans = np.concatenate([trans, np.zeros((pad, 3), np.float32)])
        self.trans = torch.as_tensor(np.asarray(trans, np.float32),
                                     device=device)
        self.rot = torch.as_tensor(np.asarray(rot, np.float32), device=device)
        self.valid = torch.as_tensor(valid, device=device)


# ---------------------------------------------------------------------------
# the plan admission ladder


def _slab_admission(cfg, cache, grids, img_init):
    """The ``slab_init`` policy: None when stage 1 stays on the gather
    engine, else a dict of the admission decision.  Memoized per (room,
    init-image shape, policy keys): its inputs are room-static."""
    memo_key = (
        "slab_adm", img_init.shape[0], img_init.shape[1],
        cfg_get(cfg, "slab_init", "auto"),
        bool(cfg_get(cfg, "sharpen_color", False)),
        bool(cfg_get(cfg, "slab_compact", False)),
        bool(cfg_get(cfg, "slab_quant", False)),
        cfg_get(cfg, "slab_bytes_cap"),
        bool(cfg_get(cfg, "seam_wrap", False)),
    )
    if memo_key not in cache:
        cache[memo_key] = _slab_admission_uncached(cfg, cache, grids,
                                                   img_init)
    return cache[memo_key]


def _auto_plans_off(device) -> bool:
    """The JAX package's CPU rule: ``auto`` plans stay off when the room
    lives on the CPU."""
    return device.type == "cpu"


def _slab_admission_uncached(cfg, cache, grids, img_init):
    mode = cfg_get(cfg, "slab_init", "auto")
    if mode is False:
        return None
    if mode == "auto" and _auto_plans_off(cache["device"]):
        return None
    from ..kernels.slab_sampling import (
        GROUP,
        default_plan_bytes_cap,
        plan_bytes_estimate,
        slab_worthwhile,
    )

    sharpen = bool(cfg_get(cfg, "sharpen_color", False))
    n_t = grids.n_trans
    compact = bool(cfg_get(cfg, "slab_compact", False))
    cap = cfg_get(cfg, "slab_bytes_cap")
    if cap is None:
        cap = default_plan_bytes_cap(cache["device"])
    # sharpen's per-query re-bake materialises a copy of what it rewrites:
    # f32 plans the 8-field streams (2x), compact plans the split target
    # stream (1.25x), q8 plans 4 of 8 B a sample (1.5x)
    m_f32 = 2.0 if sharpen else 1.0
    m_compact = 1.25 if sharpen else 1.0
    m_q8 = 1.5 if sharpen else 1.0
    n_t_build = n_t
    # slab_quant=True forces the q8 layout; auto reaches it only over the
    # compact budget
    quant = bool(cfg_get(cfg, "slab_quant", False))
    if quant:
        compact = True
    if mode == "auto":
        R = int(grids.rot.shape[0])
        n_pairs = n_t * R
        n_points = int(cache["mask"].shape[0])
        if (not compact
                and plan_bytes_estimate(n_pairs, n_points) * m_f32 > cap):
            compact = True
        est_compact = (
            plan_bytes_estimate(n_pairs, n_points, compact=True) * m_compact
        )
        if est_compact > cap:
            compact = True
            quant = True
            est_q8 = plan_bytes_estimate(n_pairs, n_points, quant=True) * m_q8
            if est_q8 > cap:
                # partial q8 plan: the leading candidate groups that fit the
                # budget, a whole number of trans rows; the gather engine
                # scores the tail
                groups_total = -(-n_pairs // GROUP)
                groups_fit = int(groups_total * cap / est_q8)
                n_t_build = groups_fit * GROUP // R
                if n_t_build < max(1, GROUP // R) or n_t_build >= n_t:
                    return None
        # a plan (with sharpen_color's per-query re-bake) must beat the
        # gather engine by the device's own rates; a partial plan is judged
        # on the pairs it covers
        if not slab_worthwhile(
            n_t_build * R, n_points, img_init.shape[0], img_init.shape[1],
            refresh=sharpen, compact=compact, device=cache["device"],
        ):
            return None
    return dict(mode=mode, n_t=n_t, n_t_build=n_t_build, compact=compact,
                quant=quant,
                cap=dict(f32=int(cap / m_f32), compact=int(cap / m_compact),
                         q8=int(cap / m_q8)),
                sharpen=sharpen, wrap=bool(cfg_get(cfg, "seam_wrap", False)))


def _maybe_slab_plan(cfg, cache, grids, img_init, sync: bool = False):
    """The room's slab plan for stage 1 (``slab_init`` key), or None for the
    gather engine.

    ``auto`` admits a plan on the card within ``slab_bytes_cap`` (default
    9/16 of the card's memory): f32, else compact, else q8, else a partial
    q8 plan, checked first by estimate and again exactly after the sizing
    pass; True builds what the layout keys ask for.  The plan covers the
    real grid rows only and is cached per (room, init-image size, layout).

    Lifecycle: plans build in line.  ``slab_plan_cache = True`` persists
    them to a content-addressed disk cache (``slab_plan_cache_dir``,
    ``slab_plan_cache_bytes``); ``auto`` means off.  With
    ``slab_background_build = True`` a miss builds on a thread while the
    room's first queries run the gather engine (``sync=True`` builds in
    line regardless).  A compact plan over budget is retried once with a
    tight block count; any other build failure marks the room and demotes
    it to the gather engine.
    """
    adm = _slab_admission(cfg, cache, grids, img_init)
    if adm is None:
        return None
    from ..kernels import plan_cache as pc
    from ..kernels.slab_sampling import (
        PlanOverBudget,
        build_grid_plan,
        nb_bucket,
        plan_required_blocks,
    )

    # n_t_build < n_t: a partial plan; _run_fused scores the tail with the
    # gather engine
    mode, n_t = adm["mode"], adm["n_t_build"]
    compact, cap, sharpen = adm["compact"], adm["cap"], adm["sharpen"]
    wrap, quant = adm["wrap"], adm["quant"]
    dev = cache["device"]
    H, W = img_init.shape[0], img_init.shape[1]

    def _build(compact, nb=None):
        q = quant and compact
        return build_grid_plan(
            cache["xyz"], cache["rgb"], cache["mask"],
            grids.trans[:n_t], grids.rot, H, W,
            compact=compact, tp_is_pid=compact and sharpen, wrap=wrap,
            nb=nb, quant=q,
            # forced modes build what was asked for; only auto admission
            # enforces the layout's budget
            bytes_cap=(
                (cap["q8"] if q else cap["compact" if compact else "f32"])
                if mode == "auto" else None
            ),
            device=dev,
        )

    def _build_tight_compact():
        # the geometric nb bucket trades padding for shape reuse; when that
        # padding alone pushes a compact plan over budget, retry once with
        # a tight (256-multiple) block count, never a larger one
        raw = plan_required_blocks(
            cache["xyz"], cache["mask"], grids.trans[:n_t], grids.rot, H, W,
            wrap=wrap, device=dev,
        )
        return _build(True, nb=min(-(-raw // 256) * 256, nb_bucket(raw)))

    # the JAX package's defaults hide a slow build on a TPU; on the H100 a
    # plan builds in line faster than it loads from the disk (PERF.md)
    use_disk = cfg_get(cfg, "slab_plan_cache", "auto")
    use_disk = use_disk != "auto" and bool(use_disk)
    background = bool(cfg_get(cfg, "slab_background_build", False)) and not sync
    cache_dir = os.path.expanduser(
        cfg_get(cfg, "slab_plan_cache_dir") or pc.default_plan_cache_dir())
    cache_budget = int(cfg_get(cfg, "slab_plan_cache_bytes", 40 * 10**9))

    def _disk_key(attempt):
        mk = ("slab_dkey", H, W, attempt, attempt and sharpen, wrap,
              quant and attempt)
        if mk not in cache:
            cache[mk] = pc.plan_key(
                cache["xyz"], cache["rgb"], cache["mask"],
                grids.trans[:n_t], grids.rot, H, W,
                attempt, attempt and sharpen, wrap=wrap,
                quant=quant and attempt,
            )
        return cache[mk]

    def _persist(plan, attempt):
        if not use_disk:
            return
        persist_cap = int(
            cfg_get(cfg, "slab_plan_persist_max_bytes", 3 * 10**9)
        )
        if plan.nbytes > persist_cap:
            return
        dkey = _disk_key(attempt)

        def run():
            try:
                pc.save_plan(cache_dir, dkey, plan, max_bytes=cache_budget)
            except Exception as exc:  # cache write failures never break runs
                print(f"slab plan cache write failed: {exc}", flush=True)

        # non-daemon: the write finishes before the interpreter exits
        threading.Thread(target=run, name="piccolo-plan-save",
                         daemon=False).start()

    for attempt in (compact, True):
        key = ("slab_plan", H, W, attempt, attempt and sharpen, wrap,
               quant and attempt)
        if key in cache:
            return cache[key]
        pend_key = ("slab_plan_pending",) + key[1:]
        if pend_key in cache:
            holder = cache[pend_key]
            if holder["thread"].is_alive():
                return None  # still building; this query uses the gather engine
            cache.pop(pend_key)
            err = holder.get("error")
            if err is None:
                cache[key] = holder["plan"]
                _persist(holder["plan"], attempt)
                return cache[key]
            if isinstance(err, PlanOverBudget) and not attempt:
                # demote f32 -> compact, and remember the f32 failure
                cache[("slab_plan_failed",) + key[1:]] = True
                continue
            print(f"slab plan build failed ({err}); using the gather engine",
                  flush=True)
            _mark_plan_failed(cache, key, sharpen)
            return None
        if (("slab_plan_failed",) + key[1:]) in cache:
            if attempt:
                return None
            continue  # f32 failed earlier; fall through to compact
        if use_disk:
            plan = pc.load_plan(cache_dir, _disk_key(attempt), device=dev)
            if plan is not None:
                cache[key] = plan
                return plan
        if background:
            holder = {"plan": None, "error": None}

            def run(holder=holder, attempt=attempt):
                try:
                    with _PLAN_BUILD_GATE:
                        holder["plan"] = _build(attempt)
                except PlanOverBudget as exc:
                    if attempt:  # compact: the tight-nb retry
                        try:
                            with _PLAN_BUILD_GATE:
                                holder["plan"] = _build_tight_compact()
                        except Exception as exc2:
                            holder["error"] = exc2
                    else:
                        holder["error"] = exc
                except Exception as exc:
                    holder["error"] = exc

            t = threading.Thread(target=run, name="piccolo-plan-build",
                                 daemon=False)
            holder["thread"] = t
            cache[pend_key] = holder
            t.start()
            return None  # the first queries run the gather engine meanwhile
        try:
            with _PLAN_BUILD_GATE:
                cache[key] = _build(attempt)
            _persist(cache[key], attempt)
            return cache[key]
        except PlanOverBudget:
            # the exact size exceeded the estimate-admitted cap: demote
            # f32 -> compact -> tight compact -> gather engine, marking
            # the failed layout so later queries skip it
            cache[("slab_plan_failed",) + key[1:]] = True
            if attempt:
                try:
                    with _PLAN_BUILD_GATE:
                        cache[key] = _build_tight_compact()
                    _persist(cache[key], attempt)
                    return cache[key]
                except PlanOverBudget:
                    return None
        except Exception as exc:
            # any other build failure (e.g. out of memory): mark the room
            # and demote to the gather engine, as the background path does
            print(f"slab plan build failed ({exc}); using the gather engine",
                  flush=True)
            _mark_plan_failed(cache, key, sharpen)
            return None
    return None


def _maybe_sharded_slab_plan(cfg, cache, grids, img_init, mesh):
    """The room's slab plans laid out on ``mesh`` (``parallel.
    shard_grid_plan``), or None for the gather engine on the mesh.

    The single-device admission picks the layout; the plans build in line,
    each shard on its own device, and are cached per (room, image size,
    layout, mesh devices).  The budget is per card: a card holds all of its
    shards (a mesh may repeat one), and over the layout's cap stage 1
    stays on the gather engine.  A partial plan (the single device's
    budget-truncated plan) keeps the gather engine under a mesh, as in the
    JAX package."""
    adm = _slab_admission(cfg, cache, grids, img_init)
    if adm is None or adm["n_t_build"] < adm["n_t"]:
        return None
    from ..kernels.slab_sampling import PlanOverBudget
    from ..parallel import shard_grid_plan

    H, W = int(img_init.shape[0]), int(img_init.shape[1])
    compact, quant, sharpen = adm["compact"], adm["quant"], adm["sharpen"]
    key = (("slab_plan_sharded", H, W, compact, compact and sharpen,
            adm["wrap"], quant) + mesh.fingerprint())
    failed = ("slab_plan_sharded_failed",) + key[1:]
    if key in cache:
        return cache[key]
    if failed in cache:
        return None
    cap = None
    if adm["mode"] == "auto":
        cap = adm["cap"]["q8" if quant else "compact" if compact else "f32"]
    try:
        with _PLAN_BUILD_GATE:
            cache[key] = shard_grid_plan(
                mesh, cache["xyz"], cache["rgb"], cache["mask"],
                grids.trans[:adm["n_t"]], grids.rot, H, W, compact=compact,
                tp_is_pid=compact and sharpen, wrap=adm["wrap"], quant=quant,
                bytes_cap=cap)
    except PlanOverBudget as exc:
        print(f"sharded slab plan over budget ({exc}); using the gather "
              "engine on the mesh", flush=True)
        cache[failed] = True
        return None
    return cache[key]


def _maybe_hist_plan(cfg, cache, grids, img_init, sync: bool = False,
                     mesh=None):
    """The room's stage-2 winner-bin planes (``hist_planes`` key), or None
    for the live splat.

    ``auto`` admits them on the card unless per-query colour rebinds are on
    (``sharpen_color`` / ``match_color``), ``criterion = loss``, or the
    planes (2 B a pixel a pair) plus the admitted slab plan exceed
    ``hist_planes_bytes_cap`` (default: the slab cap).  Same lifecycle as
    the slab plan, without the disk cache.  Under ``mesh`` the slab plan
    counts with the share its busiest card holds, and the planes in full:
    they are built whole on the lead card before they are split.
    """
    mode = cfg_get(cfg, "hist_planes", "auto")
    if mode is False:
        return None
    if cfg_get(cfg, "criterion", "loss_histogram") != "loss_histogram":
        return None
    if cfg_get(cfg, "sharpen_color", False) or cfg_get(cfg, "match_color",
                                                       False):
        return None
    H, W = int(img_init.shape[0]), int(img_init.shape[1])
    n_t = grids.n_trans
    n_pairs = n_t * int(grids.rot.shape[0])
    if mode == "auto":
        if _auto_plans_off(cache["device"]):
            return None
        from ..init.refine import hist_plan_bytes
        from ..kernels.slab_sampling import (
            default_plan_bytes_cap,
            plan_bytes_estimate,
        )

        cap = cfg_get(cfg, "hist_planes_bytes_cap")
        if cap is None:
            cap = default_plan_bytes_cap(cache["device"])
        # the planes share the memory budget with the slab plan
        slab_bytes = 0
        adm = _slab_admission(cfg, cache, grids, img_init)
        if adm is not None:
            slab_bytes = plan_bytes_estimate(
                n_pairs, int(cache["mask"].shape[0]), compact=adm["compact"],
            )
        if mesh is not None:
            busiest = max(collections.Counter(mesh.devices.flat).values())
            slab_bytes = slab_bytes * busiest // mesh.devices.size
        if hist_plan_bytes(n_pairs, H, W) + slab_bytes > cap:
            return None

    key = ("hist_plan", H, W)
    if key in cache:
        return cache[key]
    if ("hist_plan_failed", H, W) in cache:
        return None

    def _build():
        from ..init.refine import build_hist_plan

        return build_hist_plan(
            cache["xyz"], cache["rgb"], grids.trans[:n_t], grids.rot,
            H, W, point_mask=cache["mask"], device=cache["device"],
        )

    pend_key = ("hist_plan_pending", H, W)
    if pend_key in cache:
        holder = cache[pend_key]
        if holder["thread"].is_alive():
            return None  # still building; this query keeps the live splat
        cache.pop(pend_key)
        err = holder.get("error")
        if err is not None:
            print(f"hist plane build failed ({err}); using live splat",
                  flush=True)
            cache[("hist_plan_failed", H, W)] = True
            return None
        cache[key] = holder["plan"]
        return cache[key]
    if bool(cfg_get(cfg, "slab_background_build", False)) and not sync:
        holder = {"plan": None, "error": None}

        def run(holder=holder):
            try:
                with _PLAN_BUILD_GATE:
                    holder["plan"] = _build()
            except Exception as exc:
                holder["error"] = exc

        t = threading.Thread(target=run, name="piccolo-hist-plan-build",
                             daemon=False)
        holder["thread"] = t
        cache[pend_key] = holder
        t.start()
        return None
    try:
        with _PLAN_BUILD_GATE:
            cache[key] = _build()
        return cache[key]
    except Exception as exc:
        print(f"hist plane build failed ({exc}); using live splat",
              flush=True)
        cache[("hist_plan_failed", H, W)] = True
        return None


def _maybe_sharded_hist_plan(cfg, cache, grids, img_init, mesh):
    """The room's stage-2 planes split over the mesh's cand groups
    (``parallel.shard_hist_plan``), or None for the live splat: admitted
    and built as :func:`_maybe_hist_plan` does (in line), then split, and
    the whole planes dropped."""
    H, W = int(img_init.shape[0]), int(img_init.shape[1])
    key = ("hist_plan_sharded", H, W) + mesh.fingerprint()
    if key in cache:
        return cache[key]
    base = _maybe_hist_plan(cfg, cache, grids, img_init, sync=True,
                            mesh=mesh)
    if base is None:
        return None
    from ..parallel import shard_hist_plan

    cache[key] = shard_hist_plan(mesh, base)
    cache.pop(("hist_plan", H, W), None)
    return cache[key]


def _mark_plan_failed(cache, key, sharpen) -> None:
    """Mark BOTH plan layouts failed for this (room, shape): a non-budget
    build failure is not layout-specific."""
    _, H_, W_, _, _, wrap_, quant_ = key
    for a in (False, True):
        cache[("slab_plan_failed", H_, W_, a, a and sharpen, wrap_,
               quant_ and a)] = True


def _drop_slab_plans(room) -> None:
    """Free a finished room's plans promptly: queries are room-contiguous."""
    if room is None:
        return
    drop = ("slab_plan", "slab_plan_pending", "slab_plan_failed",
            "slab_dkey", "slab_adm", "hist_plan", "hist_plan_pending",
            "hist_plan_failed", "slab_plan_sharded",
            "slab_plan_sharded_failed", "hist_plan_sharded", "sharded_cloud")
    for k in [k for k in room if isinstance(k, tuple) and k and k[0] in drop]:
        room.pop(k)


def _plan_route(plan, hist_plan, n_real_pairs, criterion, mesh=None) -> str:
    """The stages' route of one query, as printed per query."""
    if plan is None:
        s1 = "gather engine"
    else:
        layout = "q8" if plan.quant else ("compact" if plan.compact else "f32")
        s1 = f"{layout} slab plan"
        if mesh is not None:
            s1 += " per shard"
        elif plan.n_pairs < n_real_pairs:
            s1 += " (partial) + gather engine tail"
    route = f"stage 1 {s1}"
    if criterion != "loss":
        s2 = "HistPlan planes" if hist_plan is not None else "live splat"
        route += f", stage 2 {s2}"
    if mesh is not None:
        c, p = mesh.devices.shape
        route = (f"mesh {c}x{p} (cand x point) over "
                 f"{', '.join(mesh.fingerprint())}: {route}")
    return route


def _run_fused(img_init, img_main, cache, rgb_used, cfg, init_dict, grids,
               mesh=None, sync_plans=False, want_traj=False, probe=False):
    """One query through ``localize_query`` on the room's device, or
    through ``parallel.localize_query_sharded`` over ``mesh`` (the room on
    its lead device; ``descent_multires_*`` is warned about and ignored
    there); returns (result or (result, traj), route).  Counts the real
    pairs stage 1 scores (``stage1.pairs``) and those a slab plan scores
    (``stage1.pairs_planned``) while tracing (``utils.profiling.count``).

    ``probe=True`` is serving's per-room ``room = "auto"`` probe: a
    truncated query whose winner loss only ranks rooms.  Stages 1 and 2 as
    usual (the room's plans compose unchanged), then a short pruned descent
    at the INIT resolution (``img_main := img_init``,
    ``room_auto_probe_iters`` iterations, prune ``(max(1, n // 3),
    min(2, num_input))``, multires off)."""
    criterion = cfg_get(cfg, "criterion", "loss_histogram")
    kw = dict(
        num_intermediate=cfg_get(cfg, "num_intermediate", 20),
        num_input=cfg_get(cfg, "num_input", 6),
        num_split_h=init_dict["num_split_h"],
        num_split_w=init_dict["num_split_w"],
        num_iter=cfg_get(cfg, "num_iter", 100),
        lr=cfg_get(cfg, "lr", 0.1),
        patience=cfg_get(cfg, "patience", 5),
        factor=cfg_get(cfg, "factor", 0.9),
        criterion=criterion,
    )
    prune = _cfg_prune(cfg, want_traj)
    multires = _cfg_multires(cfg, want_traj)
    if probe:
        img_main = img_init
        kw["num_iter"] = int(cfg_get(cfg, "room_auto_probe_iters", 30))
        prune = (max(1, kw["num_iter"] // 3), min(2, kw["num_input"]))
        multires = None
    n_real_pairs = grids.n_trans * int(grids.rot.shape[0])
    if mesh is not None:
        from ..parallel import localize_query_sharded, shard_cloud

        if multires is not None:
            _warn_once("mesh_mr", "descent_multires_* is single-device only "
                       "(the mesh descent has no multi-resolution mode) — "
                       "ignored under n_devices")
        # the room's cloud goes onto the mesh once; a rebound rgb_used
        # (sharpen_color) is placed per query
        key = ("sharded_cloud",) + mesh.fingerprint()
        if key not in cache:
            cache[key] = shard_cloud(mesh, cache["xyz"], cache["rgb"],
                                     cache["mask"])
        rebound = rgb_used is not cache["rgb"]
        plan = _maybe_sharded_slab_plan(cfg, cache, grids, img_init, mesh)
        hist_plan = (None if rebound else
                     _maybe_sharded_hist_plan(cfg, cache, grids, img_init,
                                              mesh))
        out = localize_query_sharded(
            mesh, img_init, img_main, cache[key],
            rgb_used if rebound else None, grids.trans, grids.rot,
            grids.valid, cache["lo"], cache["hi"], plan=plan,
            hist_plan=hist_plan, plan_refresh_rgb=plan is not None and rebound,
            descent_table=cfg_get(cfg, "descent_table", "auto"),
            seam_wrap=bool(cfg_get(cfg, "seam_wrap", False)),
            descent_prune=prune, **kw,
        )
        # a sharded plan is whole (a partial one stays on the gather engine)
        count("stage1.pairs", n_real_pairs)
        count("stage1.pairs_planned", 0 if plan is None else n_real_pairs)
        return out, _plan_route(plan, hist_plan, n_real_pairs,
                                kw["criterion"], mesh)
    plan = _maybe_slab_plan(cfg, cache, grids, img_init, sync=sync_plans)
    # a budget-truncated partial plan covers fewer pairs than the grids'
    # real rows: the gather engine scores the uncovered tail
    plan_tail = (
        "xla" if plan is not None and plan.n_pairs < n_real_pairs else "pad"
    )
    # a rebound rgb_used must never meet baked bins
    hist_plan = (
        _maybe_hist_plan(cfg, cache, grids, img_init, sync=sync_plans)
        if rgb_used is cache["rgb"] else None
    )
    out = localize_query(
        img_init, img_main, cache["xyz"], rgb_used, grids.trans, grids.rot,
        grids.valid, cache["lo"], cache["hi"], cache["mask"],
        masked=True, plan=plan, hist_plan=hist_plan, plan_tail=plan_tail,
        plan_refresh_rgb=plan is not None and rgb_used is not cache["rgb"],
        descent_table=cfg_get(cfg, "descent_table", "auto"),
        seam_wrap=bool(cfg_get(cfg, "seam_wrap", False)),
        trajectory=want_traj, descent_prune=prune, descent_multires=multires,
        device=cache["device"], **kw,
    )
    count("stage1.pairs", n_real_pairs)
    count("stage1.pairs_planned",
          0 if plan is None else min(plan.n_pairs, n_real_pairs))
    return out, _plan_route(plan, hist_plan, n_real_pairs, criterion)


def _shard_queries(cfg, filenames):
    """Queries are independent: ``query_shards = N`` /
    ``query_shard_index = i`` runs every N-th query from the i-th."""
    n = cfg_get(cfg, "query_shards", 1)
    i = cfg_get(cfg, "query_shard_index", 0)
    if n > 1:
        return filenames[i::n]
    return filenames


def _seed_everything():
    # host-side reproducibility parity with the reference's fixed seeds
    # (localize.py:94-101): the cloud subsample draws from np.random
    np.random.seed(2)
    random.seed(2)


def _setup_run(cfg, device, log_dir, vis: bool = False):
    """The checks and set-up both harnesses share; returns (init_dict,
    device, fused, mesh): under a mesh the device is its lead."""
    init_dict = get_init_dict(cfg)
    _check_config(cfg, init_dict)
    dev = _room_device(cfg, device)
    fused = _use_fused(cfg, init_dict)
    mesh = _check_mesh_usable(_maybe_mesh(cfg, dev), fused, vis)
    if mesh is not None:
        dev = mesh.lead
    _seed_everything()
    if cfg_get(cfg, "debug_nans", False):
        # the reference's always-on anomaly detection (localize.py:94)
        enable_nan_debug(True)
    exec_dir = cfg_get(cfg, "exec_cache_dir")
    if exec_dir:
        # the process's libraries from the cache, before the first query
        print(exec_cache.describe(exec_cache.warm(exec_dir, dev)), flush=True)
    os.makedirs(log_dir, exist_ok=True)
    return init_dict, dev, fused, mesh


def _load_room(read_fn, pcd_name, sample_rate, out_q, dev, init_dict=None):
    """A room's cache: the cloud on the host and padded on ``dev``, its
    clamp box, and (``init_dict`` given: the fused path) its grids."""
    xyz_np, rgb_np = read_fn(pcd_name, sample_rate)
    xyz_np = xyz_np.astype(np.float32)
    rgb_np = rgb_np.astype(np.float32)
    xyz_d, rgb_d, mask_d = _pad_cloud(xyz_np, rgb_np, dev)
    lo, hi = _order_bounds(xyz_np, out_q)
    room = dict(pcd=pcd_name, xyz_np=xyz_np, rgb_np=rgb_np, xyz=xyz_d,
                rgb=rgb_d, mask=mask_d, lo=lo, hi=hi, device=dev)
    if init_dict is not None:
        room["grids"] = _FusedGrids(xyz_np, init_dict, dev)
    return room


# ---------------------------------------------------------------------------
# Stanford2D-3D-S


def localize_stanford(cfg, writer=None, log_dir: str = "./log",
                      device="cuda") -> float:
    """Evaluate every Stanford2D-3D-S query panorama on ``device``.
    Returns the accuracy."""
    vis = cfg_get(cfg, "visualize", False)
    init_dict, dev, fused, mesh = _setup_run(cfg, device, log_dir, vis)
    profile_dir = cfg_get(cfg, "profile_dir")
    data_root = cfg_get(cfg, "data_root", "./data")
    area_num = cfg_get(cfg, "area")
    sample_rate = cfg_get(cfg, "sample_rate", 1)
    out_q = cfg_get(cfg, "out_of_room_quantile", 0.05)
    eval_full = cfg_get(cfg, "eval_full", False)
    room_name = cfg_get(cfg, "room_name")

    def sort_key(path):
        name = os.path.basename(path)
        return (name.split("_")[2], int(name.split("_")[3]))

    if area_num is not None:
        areas = area_num if isinstance(area_num, list) else [area_num]
        filenames = []
        for a in areas:
            filenames += sorted(
                globlib.glob(
                    os.path.join(data_root, "stanford", "pano", f"area_{a}", "*.png")
                ),
                key=sort_key,
            )
    else:
        filenames = sorted(
            globlib.glob(
                os.path.join(data_root, "stanford", "pano", "area_*", "*.png")
            ),
            key=lambda p: (
                int(p.split(os.sep)[-2].replace("area_", "")),
                sort_key(p)[0],
                sort_key(p)[1],
            ),
        )
    if room_name is not None:
        filenames = [f for f in filenames if room_name in f]
    filenames = _shard_queries(cfg, filenames)

    tracker = AccuracyTracker(STANFORD_T_THRESH, STANFORD_R_THRESH_DEG)
    summaries = ScalarSummaries(writer)
    csv_out = CsvSummary(
        os.path.join(log_dir, "stanford_results.csv"),
        STANFORD_COLUMNS,
        resume=cfg_get(cfg, "resume", False),
    )

    continue_on_error = cfg_get(cfg, "continue_on_error", False)

    failed, skipped = [], []
    # host work for query k+1 (decode, resizes, colour prep, cloud/grid
    # load) runs on a prepare thread while the card computes query k;
    # artifact encodes run on a writer thread; outputs are identical to
    # the sequential loop (prefetch.py); host_prefetch=False reverts
    prefetch_on = cfg_get(cfg, "host_prefetch", True)
    prep_cache = {"pcd": None}

    def _prepare(filename):
        area = int(filename.split(os.sep)[-2].split("_")[-1])
        img_name = os.path.basename(filename)
        room_type = img_name.split("_")[2]
        room_no = img_name.split("_")[3]
        pcd_name = data_mod.stanford_pcd_path(data_root, area, room_type, room_no)
        if prep_cache["pcd"] != pcd_name:
            prep_cache.clear()
            prep_cache.update(pcd=pcd_name, room=_load_room(
                data_mod.read_stanford, pcd_name, sample_rate, out_q, dev,
                init_dict if fused else None))
        room = prep_cache["room"]

        orig = imread_rgb(filename)  # uint8 RGB
        img_init, img_main, rgb_used, prep_timed = prepare_stanford_images(
            cfg, orig, room
        )
        gt_trans, gt_rot = data_mod.obtain_gt_stanford(data_root, area, img_name)
        return dict(
            area=area, img_name=img_name, room=room, orig=orig,
            img_init=img_init, img_main=img_main, rgb_used=rgb_used,
            gt_trans=gt_trans, gt_rot=gt_rot, prep_timed=prep_timed,
        )

    # each query's ORIGINAL index is its TensorBoard step, so resumed runs
    # continue the first run's step axis
    pending_idx = [
        i for i, f in enumerate(filenames)
        if os.path.basename(f) not in csv_out.done
    ]
    pending = [filenames[i] for i in pending_idx]
    prev_room = None
    with AsyncWriter(enabled=prefetch_on) as artifacts:
        for trial, (filename, outcome) in zip(
            pending_idx, Prefetcher(pending, _prepare, enabled=prefetch_on)
        ):
            try:
                b = Prefetcher.unwrap(outcome)
                area, img_name = b["area"], b["img_name"]
                cache = b["room"]
                if prev_room is not None and prev_room is not cache:
                    _drop_slab_plans(prev_room)
                prev_room = cache
                gt_trans, gt_rot = b["gt_trans"], b["gt_rot"]
                rgb_used = b["rgb_used"]
                img_init, img_main = b["img_init"], b["img_main"]

                if _outside_bounds(cache["lo"], cache["hi"], gt_trans) and not eval_full:
                    print(f"corrupted file : {filename}, gt_trans is out of the room\n")
                    skipped.append(filename)
                    summaries.add_text("skipped rooms", filename)
                    csv_out.write(
                        [area, img_name, fmt_array(gt_trans), fmt_array(gt_rot), 1]
                    )
                    continue

                start = time.time()
                with maybe_trace(profile_dir, name=img_name):
                    q = _localize_one(b, cache, cfg, init_dict, fused, vis,
                                      mesh)
                k, t, R, loss_k = q["k"], q["t"], q["R"], q["loss"]
                route, traj = q["route"], q["traj"]
                elapsed = time.time() - start + b["prep_timed"]

                t_err = translation_error(gt_trans, t)
                r_err = rotation_error_deg(gt_rot, R)
                ok = tracker.update(t_err, r_err)
                if not ok:
                    failed.append(filename)
                    summaries.add_text("failed rooms", filename)

                print(f"\n{img_name}")
                print(f"route : {route}{descent_note(dev)}")
                print(f"min_index : {k}")
                print(f"min loss : {loss_k}")
                print(f"translation error : {t_err}")
                print(f"rotation error : {r_err}\n")
                print(
                    f"current accuracy : {tracker.accuracy} "
                    f"({tracker.well_posed}/{tracker.total})\n"
                )
                summaries.add("current_accuracy", tracker.accuracy)

                csv_out.write(
                    [
                        area, img_name, fmt_array(gt_trans), fmt_array(gt_rot), 0,
                        fmt_array(t), fmt_array(R), t_err, r_err, elapsed,
                    ]
                )

                half = (img_main.shape[0] // 2, img_main.shape[1] // 2)
                # rendered with the colour-processed cloud (rgb_used), as the
                # reference's sharpen rebinds rgb before its result render
                # (reference localize.py:179,266-279)
                rendered = _result_render(t, R, cache["xyz"], rgb_used,
                                          cache["mask"], half)
                artifacts.submit(
                    save_result_image,
                    os.path.join(log_dir, "results", f"area_{area}", img_name),
                    b["orig"], rendered,
                )
                if vis and traj is not None:
                    frames = _gif_frames(traj, k, cache["xyz"], rgb_used,
                                         cache["mask"], half)
                    artifacts.submit(
                        save_gif,
                        os.path.join(
                            log_dir, "gifs", f"area_{area}",
                            img_name.split(".")[0] + ".gif",
                        ),
                        frames,
                    )
                summaries.write(trial)
            except Exception:
                if not continue_on_error:
                    csv_out.close()
                    raise
                failed.append(filename)
                summaries.add_text("errored rooms", filename)
                continue

    csv_out.close()
    summaries.write_scalar("final accuracy", tracker.accuracy)
    print(f"Final Accuracy : {tracker.accuracy}")
    print(f"failed {len(failed)} rooms : {failed}\n")
    print(f"skipped {len(skipped)} rooms : {skipped}")
    return tracker.accuracy


# ---------------------------------------------------------------------------
# OmniScenes


def _track_fast_ok(cfg) -> bool:
    """Whether tracked frames take the device colour prep: not when a frame
    needs a host surface (``save_starting_point`` renders against the
    colour-processed uint8 image), and colour modes only at main size (so
    device and host apply colour and resize in the same order) and, for
    ``sharpen_color``, the 256-bin default.  ``track_fast_prep = False``
    forces the host prep."""
    main_full = (cfg_get(cfg, "main_downsample_h", 1) == 1
                 and cfg_get(cfg, "main_downsample_w", 1) == 1)
    return bool(
        cfg_get(cfg, "track_fast_prep", True)
        and not cfg_get(cfg, "save_starting_point", False)
        and (not cfg_get(cfg, "match_color", False) or main_full)
        and (not cfg_get(cfg, "sharpen_color", False)
             or (main_full and cfg_get(cfg, "num_bins", 256) == 256))
    )


def _room_colour_state(cfg, room) -> None:
    """The room-static colour state of tracked frames' device prep, on the
    room's device: the cloud's CDF (``match_color``) and its sharpen state
    (``sharpen_color``)."""
    from ..color import cloud_color_cdf, cloud_sharpen_state
    from ..convert import cdf_from_numpy, sharpen_state_from_numpy

    if cfg_get(cfg, "match_color", False):
        room["cdf"] = cdf_from_numpy(cloud_color_cdf(room["rgb_np"]),
                                     room["device"])
    if cfg_get(cfg, "sharpen_color", False):
        room["sharpen"] = sharpen_state_from_numpy(
            cloud_sharpen_state(room["rgb_np"], pad_to=int(room["mask"].shape[0]),
                                num_bins=cfg_get(cfg, "num_bins", 256)),
            room["device"])


def localize_omniscenes(cfg, writer=None, log_dir: str = "./log",
                        device="cuda") -> float:
    """Evaluate every OmniScenes query panorama on ``device``.  Returns the
    accuracy.

    ``tracking = True`` (a video extension with no reference counterpart):
    each video's first frame runs the full query; every later frame runs
    ONE descent warm-started from the previous frame's pose
    (``track_num_iter``, ``track_lr``, ``track_patience``,
    ``track_factor``).  A frame whose loss diverges (non-finite, or above
    ``track_recover_ratio`` x the rolling median of the last
    ``track_window`` accepted losses) runs the full query instead and
    re-seeds.  Frames predicted tracked take the device colour prep when
    :func:`_track_fast_ok`: the prefetch thread does only the uint8 head
    (resize, ablations, main resize); the consumer thread copies the uint8
    frame to the card on its own current stream, so the copy is ordered
    before the colour prep and the descent that read it.  A prediction
    that misses finishes the host prep from that head.
    """
    init_dict, dev, fused, mesh = _setup_run(cfg, device, log_dir)
    profile_dir = cfg_get(cfg, "profile_dir")
    data_root = cfg_get(cfg, "data_root", "./data")
    split_name = cfg_get(cfg, "split_name", "extreme")
    room_name = cfg_get(cfg, "room_name")
    scene_number = cfg_get(cfg, "scene_number")
    sample_rate = cfg_get(cfg, "sample_rate", 1)
    out_q = cfg_get(cfg, "out_of_room_quantile", 0.05)
    # no visualize GIFs: the reference's OmniScenes visualize crashes
    # (omniloc.py:61); its visual artifact is save_starting_point
    save_starts = cfg_get(cfg, "save_starting_point", False)

    filenames = sorted(
        globlib.glob(data_mod.omniscenes_pano_glob(data_root, split_name)))
    if room_name is not None:
        rooms = [room_name] if isinstance(room_name, str) else room_name
        filenames = [f for f in filenames if any(r in f for r in rooms)]
    if scene_number is not None:
        filenames = [f for f in filenames if f"scene_{scene_number}" in f]
    filenames = _shard_queries(cfg, filenames)

    tracker = AccuracyTracker(OMNISCENES_T_THRESH, OMNISCENES_R_THRESH_DEG)
    summaries = ScalarSummaries(writer)
    csv_out = CsvSummary(
        os.path.join(log_dir, "omniscenes_results.csv"),
        OMNISCENES_COLUMNS,
        resume=cfg_get(cfg, "resume", False),
    )
    continue_on_error = cfg_get(cfg, "continue_on_error", False)
    failed, skipped = [], []
    prefetch_on = cfg_get(cfg, "host_prefetch", True)
    prep_cache = {"pcd": None}

    tracking_on = bool(cfg_get(cfg, "tracking", False))
    track_prev: Dict = {"video": None}
    fast_ok = tracking_on and _track_fast_ok(cfg)
    fast_track: set = set()
    if tracking_on:
        from ..tracking import (
            DivergenceGate,
            track_kwargs,
            track_step_fetched,
            track_step_prepped_fetched,
        )

        track_gate = DivergenceGate(
            window=cfg_get(cfg, "track_window", 8),
            ratio=cfg_get(cfg, "track_recover_ratio", 3.0),
        )
        track_kw = track_kwargs(cfg)

    def _prepare(filename):
        video_name = filename.split(os.sep)[-2]
        img_seq = os.path.basename(filename)
        room_type = video_name.split("_")[1]
        room_no = video_name.split("_")[2]
        pcd_name = data_mod.omniscenes_pcd_path(data_root, room_type, room_no)
        if prep_cache["pcd"] != pcd_name:
            prep_cache.clear()
            room = _load_room(data_mod.read_omniscenes, pcd_name, sample_rate,
                              out_q, dev, init_dict if fused else None)
            if fast_ok:
                _room_colour_state(cfg, room)
            prep_cache.update(pcd=pcd_name, room=room)
        room = prep_cache["room"]
        raw = imread_rgb(filename)  # the JPEG decode, on this thread
        gt_trans, gt_rot = data_mod.obtain_gt_omniscenes(filename)
        b = dict(video_name=video_name, img_seq=img_seq,
                 img_name=f"{video_name}/{img_seq}", room=room,
                 gt_trans=gt_trans, gt_rot=gt_rot)
        if filename in fast_track:
            # a predicted tracked frame: only the uint8 head here; its
            # colour prep runs on the card with the descent
            rt0 = time.time()
            orig_u8 = resize_ablate_omniscenes(cfg, raw)
            H0, W0 = orig_u8.shape[:2]
            main_u8 = resize(
                orig_u8, (W0 // cfg_get(cfg, "main_downsample_w", 1),
                          H0 // cfg_get(cfg, "main_downsample_h", 1)))
            b.update(fast=True, orig_u8=orig_u8, img_u8=main_u8,
                     rgb_used=room["rgb"], shape=(H0, W0),
                     prep_timed=time.time() - rt0)
            return b
        orig, img_init, img_main, rgb_used, prep_timed = (
            prepare_omniscenes_images(cfg, raw, room))
        b.update(orig=orig, img_init=img_init, img_main=img_main,
                 rgb_used=rgb_used, shape=orig.shape[:2],
                 prep_timed=prep_timed)
        return b

    pending_idx = [
        i for i, f in enumerate(filenames)
        if f"{f.split(os.sep)[-2]}/{os.path.basename(f)}" not in csv_out.done
    ]
    pending = [filenames[i] for i in pending_idx]
    if fast_ok:
        # predicted tracked: not the first pending frame of its video (the
        # consumer's track_prev test; misses finish the host prep inline)
        prev_vid = None
        for f in pending:
            vid = f.split(os.sep)[-2]
            if vid == prev_vid:
                fast_track.add(f)
            prev_vid = vid
    prev_room = None
    with AsyncWriter(enabled=prefetch_on) as artifacts:
        for trial, (filename, outcome) in zip(
            pending_idx, Prefetcher(pending, _prepare, enabled=prefetch_on)
        ):
            try:
                b = Prefetcher.unwrap(outcome)
                img_name, video_name = b["img_name"], b["video_name"]
                cache = b["room"]
                if prev_room is not None and prev_room is not cache:
                    _drop_slab_plans(prev_room)
                prev_room = cache
                gt_trans, gt_rot = b["gt_trans"], b["gt_rot"]
                H0, W0 = b["shape"]

                if _outside_bounds(cache["lo"], cache["hi"], gt_trans):
                    print(f"corrupted file : {filename}, gt_trans is out of the room\n")
                    skipped.append(filename)
                    summaries.add_text("skipped rooms", filename)
                    csv_out.write([img_name, fmt_array(gt_trans),
                                   fmt_array(gt_rot), 1])
                    continue

                start = time.time()
                with maybe_trace(profile_dir, name=img_name):
                    tracked = recovered = False
                    if tracking_on and track_prev["video"] == video_name:
                        box = (cache["lo"], cache["hi"], cache["mask"])
                        if b.get("fast"):
                            t, ypr_next, R, loss_k = track_step_prepped_fetched(
                                b["img_u8"], cache["xyz"], cache["rgb"],
                                track_prev["t"], track_prev["ypr"], *box,
                                cdf=cache.get("cdf"), sharpen=cache.get("sharpen"),
                                device=cache["device"], **track_kw)
                            route = "tracked: one warm-started descent, device colour prep"
                        else:
                            t, ypr_next, R, loss_k = track_step_fetched(
                                b["img_main"], cache["xyz"], b["rgb_used"],
                                track_prev["t"], track_prev["ypr"], *box,
                                device=cache["device"], **track_kw)
                            route = "tracked: one warm-started descent"
                        if not track_gate.diverged(loss_k):
                            tracked = True
                            k = 0
                            trans0 = track_prev["t"][None]
                            rot0 = track_prev["ypr"][None]
                            track_gate.accept(loss_k)
                        else:
                            recovered = True
                    if not tracked:
                        if b.get("fast"):
                            # the prediction missed (a recovery, or a seed after
                            # an errored frame): finish the host prep here
                            orig, img_init, img_main, rgb_used, _ = (
                                finish_omniscenes_images(cfg, b["orig_u8"], cache))
                            b.update(orig=orig, img_init=img_init,
                                     img_main=img_main, rgb_used=rgb_used)
                        q = _localize_one(b, cache, cfg, init_dict, fused, False,
                                          mesh)
                        k, t, R, loss_k = q["k"], q["t"], q["R"], q["loss"]
                        trans0, rot0, route = q["trans0"], q["rot0"], q["route"]
                        ypr_next = q["ypr"]
                        if tracking_on:
                            track_gate.reset()  # a fresh loss regime
                if tracking_on:
                    track_prev.update(
                        video=video_name,
                        t=np.asarray(t, np.float32).reshape(3),
                        ypr=np.asarray(ypr_next, np.float32).reshape(3),
                    )
                if save_starts:
                    # rendered with the colour-processed cloud at half the
                    # 2048x1024 size, as the reference renders its starting
                    # points (localize.py:457-471, after the rebinds at
                    # :396-410)
                    Rs = rot_from_ypr(torch.as_tensor(
                        np.asarray(rot0, np.float32))).numpy()
                    for idx in range(trans0.shape[0]):
                        rendered = _result_render(
                            trans0[idx], Rs[idx], cache["xyz"],
                            b["rgb_used"], cache["mask"], (H0 // 2, W0 // 2))
                        artifacts.submit(
                            save_result_image,
                            os.path.join(
                                log_dir, "starting_points", video_name,
                                f"{b['img_seq'].split('.')[0]}_{idx}.png"),
                            b["orig"], rendered,
                        )
                elapsed = time.time() - start + b["prep_timed"]

                t_err = translation_error(gt_trans, t)
                r_err = rotation_error_deg(gt_rot, R)
                if not tracker.update(t_err, r_err):
                    failed.append(filename)
                    summaries.add_text("failed rooms", filename)

                print(f"\n{filename}")
                print(f"route : {route}{descent_note(dev)}")
                print(f"min_index : {k}")
                print(f"min loss : {loss_k}")
                if tracking_on:
                    mode = ("tracked" if tracked
                            else "recovered" if recovered else "seed")
                    print(f"tracking : {mode}")
                print(f"translation error : {t_err}")
                print(f"rotation error : {r_err}\n")
                print(
                    f"current accuracy : {tracker.accuracy} "
                    f"({tracker.well_posed}/{tracker.total})\n"
                )
                summaries.add("current_accuracy", tracker.accuracy)
                csv_out.write([
                    img_name, fmt_array(gt_trans), fmt_array(gt_rot), 0,
                    fmt_array(t), fmt_array(R), t_err, r_err, elapsed,
                ])
                summaries.write(trial)
            except Exception:
                if not continue_on_error:
                    csv_out.close()
                    raise
                failed.append(filename)
                summaries.add_text("errored rooms", filename)
                continue

    csv_out.close()
    summaries.write_scalar("final accuracy", tracker.accuracy)
    print(f"Final Accuracy : {tracker.accuracy}")
    print(f"failed {len(failed)} rooms\n")
    print(f"skipped {len(skipped)} rooms")
    return tracker.accuracy
