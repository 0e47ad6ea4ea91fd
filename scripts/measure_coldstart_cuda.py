#!/usr/bin/env python3
"""What a fresh process of the port pays before its first answer, on the card.

    python3 scripts/measure_coldstart_cuda.py [--kinds default,default,exec,exec]
        [--out FILE]

The counterpart of ``scripts/measure_coldstart.py`` for
``piccolo_tpu_torch``.  It starts one fresh worker process a word of
``--kinds``, in turn.  An ``exec`` worker builds or loads its libraries in
one executable-cache directory (``utils.exec_cache``), empty before the
first ``exec`` worker: the first builds every library, the ones after it
load them.  A ``default`` worker sets no cache: it builds or loads them in
the default build directory, ``kernels/_build/``, as every process does,
so the first ``default`` worker on a fresh checkout builds and the ones
after it load.  Each worker runs the library path at ``bench.py``'s Stanford
scale (``chip_smoke.py``'s phase-3 room: 60,000 points padded to 65,536,
50 x 8 candidates, 1024x512 main and 512x256 init images, an f32
``GridPlan`` and a ``HistPlan``) and times, in order:

  import_s       ``import torch`` and the package
  cuda_init_s    the CUDA context (first allocation, synchronised)
  builds_s       the kernel libraries (``nvcc``) and the JPEG codec (host
                 ``c++``) through its store, with the store's hits and
                 builds (``store``)
  room_s         the synthetic room and its candidate grids, on the host
  grid_plan_s, hist_plan_s   the plan builds on the card
  query_s        three queries in turn: the first captures the descent's
                 graph (``capture_s``, from ``solver.graph_stats``), the
                 others replay it
  first_extra_s  the first query less its capture and the later queries'
                 median: the first run of each PyTorch kernel and of the
                 allocator's pools

and ``total_s``, from the worker's start to its first answer on the host.
After the queries it times the GridPlan through the plan disk cache
(``kernels/plan_cache.py``: ``plan_save_s``, ``plan_load_s``, its bytes):
would it reload faster than it builds?
With ``--profile`` the last worker then runs the first query's image under
``utils.maybe_trace`` twice: on its cached graph (the same winner and
pose bits as unprofiled, no capture) and with four starts, a graph key
captured under the profiler; it lists the trace files written.
The parent adds each process's wall seconds and prints one JSON line with
every worker's split and the card's name and power limit (``nvidia-smi``);
``--out`` also writes it to a file.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(cache_dir: str, scratch: str, profile_dir: str = "") -> dict:
    """One fresh process's split; ``cache_dir`` "default": no cache, the
    default build directory."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from piccolo_tpu_torch import build_grid_plan, build_hist_plan, localize_query
    from piccolo_tpu_torch import solver
    from piccolo_tpu_torch.harness.localize import _order_bounds, _pad_cloud
    from piccolo_tpu_torch.init.candidates import (
        default_init_dict,
        generate_rot_points,
        generate_trans_points,
    )
    from piccolo_tpu_torch.kernels import plan_cache
    from piccolo_tpu_torch.kernels.slab_sampling import default_plan_bytes_cap
    from piccolo_tpu_torch.harness import imaging
    from piccolo_tpu_torch.kernels import _build
    from piccolo_tpu_torch.testing import make_room, random_pose_inside, render_at
    from piccolo_tpu_torch.utils import exec_cache

    out = {}
    mark = [time.perf_counter()]
    out["import_s"] = mark[0] - T_START

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = now - mark[0]
        mark[0] = now

    if not torch.cuda.is_available():
        raise SystemExit("measure_coldstart_cuda: needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    lap("cuda_init_s")
    if cache_dir == "default":
        # what the first query would build or load on its own, up front
        store = _build.library_store()
        for name in _build.KERNEL_SOURCES:
            _build.load_library(name)
        imaging._codec()
        out["store"] = dict(dir=str(store.path), hits=store.hits,
                            built=store.built_names, rebuilt=store.rebuilt)
    else:
        stats = exec_cache.warm(cache_dir, dev)
        out["store"] = {k: stats[k] for k in ("dir", "hits", "built",
                                              "rebuilt")}
    lap("builds_s")

    size = (6.0, 4.0, 3.0)
    rng = np.random.default_rng(7)
    xyz, rgb = make_room(rng, n_per_wall=10000, size=size, texture="checker")
    xyz_d, rgb_d, mask_d = _pad_cloud(xyz, rgb, dev)
    lo, hi = _order_bounds(xyz, 0.05)
    d = default_init_dict(xy_only=True, yaw_only=True, num_yaw=8,
                          num_split_h=4, num_split_w=4, num_trans=50,
                          z_prior=None)
    trans = generate_trans_points(xyz, d)
    rot = generate_rot_points(d)
    pad = (-trans.shape[0]) % 64
    trans_p = np.concatenate([trans, np.zeros((pad, 3), np.float32)])
    valid = np.arange(trans_p.shape[0]) < trans.shape[0]
    lap("room_s")
    plan = build_grid_plan(xyz_d, rgb_d, mask_d, trans, rot, 256, 512,
                           bytes_cap=default_plan_bytes_cap(dev), device=dev)
    lap("grid_plan_s")
    hplan = build_hist_plan(xyz_d, rgb_d, trans, rot, 256, 512,
                            point_mask=mask_d, chunk=32, device=dev)
    lap("hist_plan_s")

    queries, errs, winners = [], [], []
    for seed in (200, 201, 202):
        gt_t, gt_ypr = random_pose_inside(np.random.default_rng(seed), size)
        img_main = render_at(xyz, rgb, gt_t, gt_ypr, (512, 1024), device=dev)
        img_init = img_main[::2, ::2].contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = localize_query(
            img_init, img_main, xyz_d, rgb_d, trans_p, rot, valid, lo, hi,
            mask_d, num_intermediate=20, num_input=6, num_iter=100, lr=0.1,
            patience=5, factor=0.8, masked=True, plan=plan, hist_plan=hplan,
            descent_table="auto", device=dev)
        t = res.t.cpu().numpy()
        queries.append(time.perf_counter() - t0)
        winners.append(int(res.winner))
        errs.append(float(np.linalg.norm(t - gt_t)))
        if seed == 200:
            out["total_s"] = time.perf_counter() - T_START
            first_t = t
    graphs = solver.graph_stats()
    # after the first answer: would the GridPlan reload faster than it builds?
    out["plan_bytes"] = int(plan.nbytes)
    with tempfile.TemporaryDirectory(dir=scratch) as pdir:
        lap("queries_s")
        plan_cache.save_plan(pdir, "coldstart", plan)
        lap("plan_save_s")
        loaded = plan_cache.load_plan(pdir, "coldstart", device=dev)
        lap("plan_load_s")
        out["plan_file_bytes"] = sum(
            os.path.getsize(os.path.join(pdir, f)) for f in os.listdir(pdir))
    del loaded
    if profile_dir:
        # the first query's image again under the profiler (its graph is
        # cached), then four starts (a new graph key, captured under it)
        from piccolo_tpu_torch.utils import maybe_trace

        prof = {}
        for label, n_in in (("cached", 6), ("capture", 4)):
            gt_t, gt_ypr = random_pose_inside(np.random.default_rng(200), size)
            img_main = render_at(xyz, rgb, gt_t, gt_ypr, (512, 1024),
                                 device=dev)
            before = solver.graph_stats()["captures"]
            with maybe_trace(profile_dir, name=label):
                res = localize_query(
                    img_main[::2, ::2].contiguous(), img_main, xyz_d, rgb_d,
                    trans_p, rot, valid, lo, hi, mask_d,
                    num_intermediate=20, num_input=n_in, num_iter=100,
                    lr=0.1, patience=5, factor=0.8, masked=True, plan=plan,
                    hist_plan=hplan, descent_table="auto", device=dev)
                t = res.t.cpu().numpy()
            prof[label] = dict(
                winner=int(res.winner), t_err_m=float(np.linalg.norm(t - gt_t)),
                t_equal_unprofiled=bool(np.array_equal(t, first_t)),
                new_captures=solver.graph_stats()["captures"] - before)
        prof["traces"] = sorted(os.listdir(profile_dir))
        out["profile_check"] = prof
    out["query_s"] = queries
    out["t_err_m"] = errs
    out["winners"] = winners
    out["captures"] = graphs["captures"]
    out["capture_s"] = sum(g["capture_s"] for g in graphs["graphs"])
    out["first_extra_s"] = (queries[0] - out["capture_s"]
                            - float(np.median(queries[1:])))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kinds", default="default,default,exec,exec",
                    help="one fresh worker a word, in turn: 'default' (no "
                         "cache, kernels/_build/) or 'exec' (one "
                         "executable-cache directory, empty at first)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="the last worker also runs two queries under "
                         "utils.maybe_trace: one on a cached graph, one "
                         "that captures a new key")
    ap.add_argument("--worker", metavar="CACHE_DIR", default=None)
    ap.add_argument("--scratch", default=None)
    ap.add_argument("--profile-dir", default="")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.scratch,
                                args.profile_dir)), flush=True)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    runs = []
    kinds = args.kinds.split(",")
    if set(kinds) - {"default", "exec"}:
        raise SystemExit(f"--kinds: 'default' or 'exec', not {args.kinds}")
    with tempfile.TemporaryDirectory(prefix="piccolo_coldstart_") as scratch:
        cache_dir = os.path.join(scratch, "exec")
        for i, kind in enumerate(kinds):
            extra = []
            if args.profile and i == len(kinds) - 1:
                extra = ["--profile-dir", os.path.join(scratch, "traces")]
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 cache_dir if kind == "exec" else "default", "--scratch",
                 scratch, *extra], capture_output=True, text=True,
                timeout=900)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                raise SystemExit(f"a worker failed (rc {proc.returncode})")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            run["kind"] = kind
            run["process_wall_s"] = wall
            runs.append(run)
    line = json.dumps(dict(card=smi[0] if smi else None, runs=runs))
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
