#!/usr/bin/env python3
"""The slab plan's lifecycle in the PyTorch/CUDA port: a dense room's
first queries, on the card.

    python3 scripts/measure_plan_lifecycle_cuda.py --cache-dir DIR
        [--points 240000] [--height 1024] [--queries 4]
        [--sync] [--no-cache] [--disk] [--device cuda|cpu]

The counterpart of ``scripts/measure_plan_lifecycle.py`` for
``piccolo_tpu_torch``, with its flags, defaults, room, queries, budget and
JSON keys.  It times each query of one dense room as the batch harness
runs it (``harness.localize._run_fused`` over ``_FusedGrids``, the full
panorama as both the init and the main image):

  --sync       q0 builds the slab plan in line before it answers.
  (default)    the plan builds on a background thread while the first
               queries run stage 1 on the gather engine; later queries
               use the slab kernel.  The plan disk cache follows its
               ``auto`` default (off in the port).
  --disk       the disk cache on: run it TWICE with the same --cache-dir
               to see the second process load the plan (plans above
               ``slab_plan_persist_max_bytes``, 3 GB, are never written).
  --no-cache   the disk cache off.

The background build and the disk cache are passed explicitly, as the JAX
script passes them (the port's defaults are off).  One JSON line gives each
query's seconds, whether the room held a slab plan after it, the plan's
route and size, and ``device``: the card's ``nvidia-smi`` name and power
limit, or ``"cpu"``.  The JAX package's record is ``docs/ROUND3.md``
(plan lifecycle table).  Runs on the card; without one it raises unless
given ``--device cpu``, where ``auto`` admits no plan, as in the JAX
package: stage 1 stays on the gather engine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from piccolo_tpu_torch.config import cfg_get, make_config  # noqa: E402
from piccolo_tpu_torch.device import resolve_device  # noqa: E402
from piccolo_tpu_torch.eval_synth import device_label  # noqa: E402
from piccolo_tpu_torch.harness.localize import (  # noqa: E402
    _FusedGrids,
    _maybe_slab_plan,
    _order_bounds,
    _pad_cloud,
    _plan_route,
    _run_fused,
    get_init_dict,
)
from piccolo_tpu_torch.testing import make_room, random_pose_inside, render_at  # noqa: E402
from piccolo_tpu_torch.utils import enable_compilation_cache  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cache-dir", required=True)
    ap.add_argument("--points", type=int, default=240000)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--sync", action="store_true",
                    help="build the plan in line on the first query")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the disk cache (isolate background build)")
    ap.add_argument("--disk", action="store_true",
                    help="force the disk cache ON (its 'auto' default is "
                         "off in the port)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or on the CPU")
    return ap.parse_args(argv)


def _npz_entries(cache_dir):
    return [n for n in (os.listdir(cache_dir) if os.path.isdir(cache_dir)
                        else []) if n.endswith(".npz")]


def _slab_plans(cache):
    return [v for k, v in cache.items()
            if isinstance(k, tuple) and k and k[0] == "slab_plan"]


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    enable_compilation_cache()
    rng = np.random.default_rng(13)
    size = (6.0, 4.0, 3.0)
    xyz, rgb = make_room(rng, n_per_wall=args.points // 6, size=size,
                         texture="checker")
    xyz, rgb = xyz.astype(np.float32), rgb.astype(np.float32)
    xyz_d, rgb_d, mask_d = _pad_cloud(xyz, rgb, dev)
    lo, hi = _order_bounds(xyz, 0.05)

    cfg = make_config(
        dataset="OmniScenes",
        num_trans=150, xy_only=True, yaw_only=True, num_yaw=8, z_prior=None,
        num_intermediate=50, num_input=6, num_iter=100, factor=0.8,
        num_split_h=4, num_split_w=4,
        slab_plan_cache=(
            False if args.no_cache else (True if args.disk else "auto")
        ),
        slab_plan_cache_dir=args.cache_dir,
        slab_background_build=not args.sync,
    )
    init_dict = get_init_dict(cfg)
    grids = _FusedGrids(xyz, init_dict, dev)
    cache = dict(xyz=xyz_d, rgb=rgb_d, mask=mask_d, lo=lo, hi=hi,
                 grids=grids, device=dev)

    H, W = args.height, 2 * args.height
    # pre-render all queries so ground-truth rendering never enters the
    # timings
    queries = []
    for qi in range(args.queries):
        gt_t, gt_ypr = random_pose_inside(
            np.random.default_rng(100 + qi), size
        )
        img = render_at(xyz, rgb, gt_t, gt_ypr, (H, W), device=dev)
        queries.append((img, gt_t))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    times, errs, plan_used, routes = [], [], [], []
    for qi, (img, gt_t) in enumerate(queries):
        t0 = time.time()
        res, route = _run_fused(
            img, img, cache, rgb_d, cfg, init_dict, grids,
            sync_plans=args.sync,
        )
        t = res.t.cpu().numpy()
        times.append(round(time.time() - t0, 3))
        errs.append(float(np.linalg.norm(t - gt_t)))
        plan_used.append(bool(_slab_plans(cache)))
        routes.append(route)
        print(f"q{qi}: {times[-1]:.3f} s, t_err {errs[-1]:.4f} m, {route}",
              flush=True)

    # drain: let an in-flight background build finish and persist, so that
    # the next process (run 2) finds the disk entry; in the batch loop the
    # room's later queries do this
    if not args.sync:
        deadline = time.time() + 180
        while time.time() < deadline:
            if _maybe_slab_plan(cfg, cache, grids, queries[0][0]) is not None:
                break
            if not any(isinstance(k, tuple) and k[0] == "slab_plan_pending"
                       for k in cache):
                break  # nothing building: the room runs the gather engine
            time.sleep(0.5)
    # a plan over the persist bound is never written: no entry to wait for
    persist_cap = cfg_get(cfg, "slab_plan_persist_max_bytes", 3 * 10**9)
    plans = _slab_plans(cache)
    if args.disk and plans and all(p.nbytes <= persist_cap for p in plans):
        deadline = time.time() + 180
        while time.time() < deadline:
            if _npz_entries(args.cache_dir):
                break
            time.sleep(0.5)

    n_real = grids.n_trans * int(grids.rot.shape[0])
    out = dict(
        mode=("sync" if args.sync else "background")
        + ("+disk" if args.disk else ("" if args.no_cache else "+disk_auto")),
        sec_per_query=times,
        plan_resident_after_query=plan_used,
        median_t_err_m=round(float(np.median(errs)), 4),
        cache_entries=len(_npz_entries(args.cache_dir)),
        routes=routes,
        plan=[dict(route=_plan_route(p, None, n_real, "loss"),
                   bytes=int(p.nbytes)) for p in plans],
        device=device_label(dev),
    )
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
