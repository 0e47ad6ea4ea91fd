"""Stanford2D-3D-S evaluation harness (port of
piccolo_tpu/harness/localize.py, the single-device fused path).

Per query: file discovery, cloud loading on room change, colour
preprocessing, the out-of-room gate, the fused query
(``pipeline.localize_query``), error metrics, accuracy accounting and the
CSV / TensorBoard / image artifacts, with the reference's schemas.

Stage 1 runs through the JAX package's plan admission ladder
(``_slab_admission``): slab off, or the f32 plan, demoted to the compact
plan, the q8 plan, a partial q8 plan with a gather-engine tail, or the
gather engine, by the plan-memory budget and the per-query cost model
``slab_worthwhile``.  Plans are built once per room and init-image size,
in line by default.  ``slab_background_build = True`` builds them on a
thread while the room's first queries run the gather engine, and
``slab_plan_cache = True`` persists them to a disk cache that the JAX
package shares.  Both are off by default, unlike in the JAX package: on
the H100 a plan builds faster than it loads from the disk (PERF.md).  A
plan build that fails demotes stage 1 to the gather engine; the kernels'
own build and launch errors are never caught.

The CPU rule of the JAX package (``auto`` plans off on the CPU backend)
becomes: ``auto`` plans are off when the room lives on the CPU.  Config
keys of later slices (OmniScenes, the staged path, multi-device, descent
prune and multires, profiling, the executable cache) raise
``NotImplementedError`` naming the slice; none is ignored.
"""

from __future__ import annotations

import glob as globlib
import os
import random
import threading
import time
from typing import Dict, Tuple

import numpy as np
import torch

from .. import data as data_mod
from ..color import color_mod
from ..config import cfg_get
from ..convert import cloud_from_numpy
from ..device import resolve_device
from ..init.candidates import generate_rot_points, generate_trans_points
from ..init.refine import check_criterion
from ..ops.pano import render_pano
from ..ops.quantile import cloud_bounds, outside_box
from ..ops.rotation import rot_from_ypr
from ..pipeline import localize_query
from .imaging import imread_rgb, resize
from .metrics import (
    STANFORD_R_THRESH_DEG,
    STANFORD_T_THRESH,
    AccuracyTracker,
    rotation_error_deg,
    translation_error,
)
from .outputs import (
    STANFORD_COLUMNS,
    CsvSummary,
    ScalarSummaries,
    fmt_array,
    save_gif,
    save_result_image,
)
from .prefetch import AsyncWriter, Prefetcher

__all__ = ["localize_stanford", "get_init_dict", "prepare_stanford_images"]

# One slab-plan build at a time, process-wide: an orphaned background build
# of the previous room keeps its memory until it finishes, and two near-cap
# plans must never be resident at once.
_PLAN_BUILD_GATE = threading.Semaphore(1)


def _unported(what: str, where: str):
    return NotImplementedError(
        f"{what} is not ported to piccolo_tpu_torch yet: it comes with the "
        f"{where} slice of the port"
    )


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
    img_init = resize(orig, (W0 // init_dw, H0 // init_dh)).astype(np.float32) / 255.0
    rgb_used = room["rgb"]
    if cfg_get(cfg, "sharpen_color", False):
        img_init, rgb_mod = color_mod(
            img_init, room["rgb_np"], cfg_get(cfg, "num_bins", 256)
        )
        rgb_used = _pad_rgb(rgb_mod, int(room["mask"].shape[0]),
                            room["device"])
    rt0 = time.time()
    img_main = resize(orig, (W0 // main_dw, H0 // main_dh)).astype(np.float32) / 255.0
    prep_timed = time.time() - rt0
    return img_init, img_main, rgb_used, prep_timed


def _check_config(cfg, init_dict) -> None:
    """Refuse, loudly, the keys whose paths belong to later slices."""
    if cfg_get(cfg, "n_devices") not in (None, 0, 1):
        raise _unported("n_devices > 1 (one query sharded over a mesh)",
                        "multi-device")
    if not cfg_get(cfg, "fused", True):
        raise _unported("fused = False (the staged path, make_input)",
                        "staged-path")
    if init_dict.get("sample_rate_for_init") is not None:
        raise _unported("sample_rate_for_init (the staged path, make_input)",
                        "staged-path")
    check_criterion(cfg_get(cfg, "criterion", "loss_histogram"))
    if int(cfg_get(cfg, "descent_prune_iter", 0) or 0) > 0:
        raise _unported("descent_prune_* (the pruned descent)",
                        "descent prune and multires")
    if int(cfg_get(cfg, "descent_multires_iter", 0) or 0) > 0:
        raise _unported("descent_multires_* (the multi-resolution descent)",
                        "descent prune and multires")
    if cfg_get(cfg, "profile_dir"):
        raise _unported("profile_dir (per-query traces)", "profiling")
    if cfg_get(cfg, "exec_cache_dir"):
        raise _unported("exec_cache_dir (the executable cache)", "serving")
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
    if dev.type != "cuda":
        raise ValueError("device_index pins the run to one card; it needs "
                         "--device cuda")
    i = int(i)
    if not 0 <= i < torch.cuda.device_count():
        raise ValueError(f"device_index={i} but only "
                         f"{torch.cuda.device_count()} devices are visible")
    return torch.device("cuda", i)


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
        # a per-query re-bake (sharpen_color) is only worth it when the
        # gather engine is slow enough; a partial plan is judged on the
        # pairs it covers
        if not slab_worthwhile(
            n_t_build * R, n_points, img_init.shape[0], img_init.shape[1],
            refresh=sharpen, compact=compact,
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


def _maybe_hist_plan(cfg, cache, grids, img_init, sync: bool = False):
    """The room's stage-2 winner-bin planes (``hist_planes`` key), or None
    for the live splat.

    ``auto`` admits them on the card unless per-query colour rebinds are on
    (``sharpen_color`` / ``match_color``), ``criterion = loss``, or the
    planes (2 B a pixel a pair) plus the admitted slab plan exceed
    ``hist_planes_bytes_cap`` (default: the slab cap).  Same lifecycle as
    the slab plan, without the disk cache.
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
            "hist_plan_failed")
    for k in [k for k in room if isinstance(k, tuple) and k and k[0] in drop]:
        room.pop(k)


def _plan_route(plan, hist_plan, n_real_pairs, criterion) -> str:
    """The stages' route of one query, as printed per query."""
    if plan is None:
        s1 = "gather engine"
    else:
        layout = "q8" if plan.quant else ("compact" if plan.compact else "f32")
        s1 = f"{layout} slab plan"
        if plan.n_pairs < n_real_pairs:
            s1 += " (partial) + gather engine tail"
    if criterion == "loss":
        return f"stage 1 {s1}"
    s2 = "HistPlan planes" if hist_plan is not None else "live splat"
    return f"stage 1 {s1}, stage 2 {s2}"


def _run_fused(img_init, img_main, cache, rgb_used, cfg, init_dict, grids,
               sync_plans=False, want_traj=False):
    """One query through ``localize_query`` on the room's device; returns
    (result or (result, traj), route)."""
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
    plan = _maybe_slab_plan(cfg, cache, grids, img_init, sync=sync_plans)
    # a budget-truncated partial plan covers fewer pairs than the grids'
    # real rows: the gather engine scores the uncovered tail
    n_real_pairs = grids.n_trans * int(grids.rot.shape[0])
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
        trajectory=want_traj, device=cache["device"], **kw,
    )
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


# ---------------------------------------------------------------------------
# Stanford2D-3D-S


def localize_stanford(cfg, writer=None, log_dir: str = "./log",
                      device="cuda") -> float:
    """Evaluate every Stanford2D-3D-S query panorama on ``device``.
    Returns the accuracy."""
    init_dict = get_init_dict(cfg)
    _check_config(cfg, init_dict)
    dev = _room_device(cfg, device)
    _seed_everything()
    if cfg_get(cfg, "debug_nans", False):
        # the reference's always-on anomaly detection (localize.py:94)
        torch.autograd.set_detect_anomaly(True)
    os.makedirs(log_dir, exist_ok=True)

    data_root = cfg_get(cfg, "data_root", "./data")
    area_num = cfg_get(cfg, "area")
    sample_rate = cfg_get(cfg, "sample_rate", 1)
    out_q = cfg_get(cfg, "out_of_room_quantile", 0.05)
    eval_full = cfg_get(cfg, "eval_full", False)
    vis = cfg_get(cfg, "visualize", False)
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
            xyz_np, rgb_np = data_mod.read_stanford(pcd_name, sample_rate)
            xyz_np = xyz_np.astype(np.float32)
            rgb_np = rgb_np.astype(np.float32)
            xyz_d, rgb_d, mask_d = _pad_cloud(xyz_np, rgb_np, dev)
            lo, hi = _order_bounds(xyz_np, out_q)
            room = dict(
                pcd=pcd_name, xyz_np=xyz_np, rgb_np=rgb_np,
                xyz=xyz_d, rgb=rgb_d, mask=mask_d, lo=lo, hi=hi, device=dev,
                grids=_FusedGrids(xyz_np, init_dict, dev),
            )
            prep_cache.clear()
            prep_cache.update(pcd=pcd_name, room=room)
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
                fres, route = _run_fused(
                    img_init, img_main, cache, rgb_used, cfg, init_dict,
                    cache["grids"], want_traj=vis,
                )
                if vis:
                    fres, traj = fres
                else:
                    traj = None
                k = int(fres.winner)
                t = fres.t.cpu().numpy()
                R = fres.rot.cpu().numpy()
                loss_k = float(fres.loss)
                elapsed = time.time() - start + b["prep_timed"]

                t_err = translation_error(gt_trans, t)
                r_err = rotation_error_deg(gt_rot, R)
                ok = tracker.update(t_err, r_err)
                if not ok:
                    failed.append(filename)
                    summaries.add_text("failed rooms", filename)

                print(f"\n{img_name}")
                print(f"route : {route}")
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
