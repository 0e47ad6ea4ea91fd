#!/usr/bin/env python3
"""The mesh path's restart through the executable cache, in the
PyTorch/CUDA port, on the card.

    python3 scripts/measure_sharded_coldstart_cuda.py --exec-cache DIR
        [--points 240000] [--height 1024] [--num-iter 100]
        [--device cuda|cpu]

The counterpart of ``scripts/measure_sharded_coldstart.py`` for
``piccolo_tpu_torch``, with its flags, defaults, room, query, budget and
JSON keys.  It runs ``parallel.localize_query_sharded(...,
exec_cache_dir=DIR)`` twice in one process over ``parallel.make_mesh`` of
the visible cards (1 x 1 on one card, 1 x n on n cards; on the CPU a 1 x 1
mesh of one logical shard).  Run it TWICE with the same DIR:

  run 1: builds the kernel libraries and the JPEG codec into DIR;
  run 2 (the restart): loads every one of them from DIR.

The JAX package's cache holds compiled programs; the port's holds the
built libraries (``utils.exec_cache``; its descent graphs are captured
anew in every process).  So where the JAX script times its cache's load
and store, this one reports the cache's own ``warm`` stats: ``loaded``
(every library a hit), ``load_s`` (the warm-up's seconds), ``bytes`` (the
libraries in DIR), with ``hits`` and ``built`` by name, and the first
query's graph captures (``solver.graph_stats``).  ``fetch_init_s`` is the
CUDA context (a first allocation, synchronised).  One JSON line a run,
with ``device``: the card's ``nvidia-smi`` name and power limit, or
``"cpu"``.  The JAX package's record is ``docs/ROUND5.md`` (sharded
restart).  Runs on the card; without one it raises unless given
``--device cpu``.
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

from piccolo_tpu_torch import solver  # noqa: E402
from piccolo_tpu_torch.device import resolve_device  # noqa: E402
from piccolo_tpu_torch.eval_synth import device_label  # noqa: E402
from piccolo_tpu_torch.harness.localize import _order_bounds  # noqa: E402
from piccolo_tpu_torch.init.candidates import (  # noqa: E402
    default_init_dict,
    generate_rot_points,
    generate_trans_points,
)
from piccolo_tpu_torch.kernels import _build  # noqa: E402
from piccolo_tpu_torch.parallel import localize_query_sharded, make_mesh  # noqa: E402
from piccolo_tpu_torch.testing import make_room, random_pose_inside, render_at  # noqa: E402
from piccolo_tpu_torch.utils import exec_cache  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--exec-cache", required=True, metavar="DIR")
    ap.add_argument("--points", type=int, default=240000)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--num-iter", type=int, default=100)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or on the CPU")
    return ap.parse_args(argv)


def _entries(cache_dir):
    """The built libraries in ``cache_dir`` (each beside its digest)."""
    if not os.path.isdir(cache_dir):
        return []
    return sorted(n for n in os.listdir(cache_dir) if n.endswith(".so"))


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    out: dict = {
        "mode": "sharded-coldstart",
        "device": device_label(dev),
        "n_devices": len(devices),
    }
    out["restart"] = bool(_entries(args.exec_cache))

    # the CUDA context, on a 1-element tensor, outside the timings below
    t0 = time.time()
    torch.zeros((1,), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["fetch_init_s"] = round(time.time() - t0, 2)

    rng = np.random.default_rng(13)
    size = (6.0, 4.0, 3.0)
    xyz, rgb = make_room(rng, n_per_wall=args.points // 6, size=size,
                         texture="checker")
    pano_hw = (args.height, 2 * args.height)
    init_dict = default_init_dict(
        xy_only=True, yaw_only=True, num_yaw=8, num_trans=150, z_prior=None,
        num_split_h=4, num_split_w=4,
    )
    trans_np = generate_trans_points(xyz, init_dict)
    rot_np = generate_rot_points(init_dict)
    n_trans = trans_np.shape[0]
    pad = (-n_trans) % 64
    trans_valid_np = np.ones(n_trans + pad, bool)
    if pad:
        trans_valid_np[-pad:] = False
        trans_np = np.concatenate([trans_np, np.zeros((pad, 3), np.float32)])
    lo_np, hi_np = _order_bounds(xyz, 0.05)
    q = np.random.default_rng(99)
    gt_t, gt_ypr = random_pose_inside(q, size)
    img_main = render_at(xyz, rgb, gt_t, gt_ypr, pano_hw, device=dev)
    img_init = img_main[::4, ::4].contiguous()

    mesh = (make_mesh(1, len(devices), devices=devices) if len(devices) > 1
            else make_mesh(1, 1, devices=devices))
    out["mesh"] = dict(mesh.shape)

    def query():
        return localize_query_sharded(
            mesh, img_init, img_main, xyz.astype(np.float32),
            rgb.astype(np.float32), trans_np, rot_np, trans_valid_np,
            lo_np, hi_np,
            num_intermediate=50, num_input=6, num_iter=args.num_iter,
            lr=0.1, patience=5, factor=0.8,
            exec_cache_dir=args.exec_cache,
        )

    t0 = time.time()
    res = query()
    t = res.t.cpu().numpy()
    out["first_query_s"] = round(time.time() - t0, 2)
    out["t_err_m"] = round(float(np.linalg.norm(t - gt_t)), 4)
    stats = exec_cache.warm(args.exec_cache, mesh.lead)
    n_libs = len(_build.KERNEL_SOURCES) * (mesh.lead.type == "cuda") + 1
    out["loaded"] = len(stats["hits"]) == n_libs and not stats["built"]
    out["load_s"] = round(stats["seconds"], 2)
    out["bytes"] = sum(os.path.getsize(os.path.join(args.exec_cache, n))
                       for n in _entries(args.exec_cache))
    out["hits"] = list(stats["hits"])
    out["built"] = list(stats["built"])
    graphs = solver.graph_stats()
    out["graph_captures"] = graphs["captures"]
    out["graph_capture_s"] = round(sum(g["capture_s"]
                                       for g in graphs["graphs"]), 3)

    t0 = time.time()
    res = query()
    res.t.cpu().numpy()
    out["steady_s"] = round(time.time() - t0, 2)

    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
