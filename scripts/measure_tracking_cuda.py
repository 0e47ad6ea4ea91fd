#!/usr/bin/env python3
"""Video-rate tracking of the PyTorch/CUDA port, on the card.

    python3 scripts/measure_tracking_cuda.py [--frames 60] [--height 512]
        [--points 60000] [--num-iter 30] [--teleport] [--teleport-every K]
        [--seed 3] [--device cuda|cpu]

The counterpart of ``scripts/measure_tracking.py`` for
``piccolo_tpu_torch``, with its flags, defaults, scene, trajectory and
JSON keys.  It renders a smooth handheld-like trajectory in a ray-cast
scene (dense camera-like frames), seeds the ``Tracker`` with one full
``localize_query`` on frame 0 (50 x 8 candidates padded to 64 rows, 20 ->
6 starts x 100 iterations at lr 0.1), then times every warm-started frame.
``--teleport`` moves the camera across the room from the middle frame on,
and ``--teleport-every K`` jumps at every K-frame boundary: a diverged
frame re-runs the full query (recovery).  Every ground-truth pose equals
the JAX script's bit for bit.

Timing: each frame is rendered on the host (outside the clock) and moved
to the device, the device is synchronised, and the clock runs until
``Tracker.update`` returns its pose on the host.  ``median_ms`` leaves out
frames 1-2 (graph capture) and the recovered frames.  Before the summary a
``graphs:`` line gives the descent graphs captured in the run
(``solver.graph_stats``) and how many had been captured by frame 2.  The
summary adds ``device``: the card's ``nvidia-smi`` name and power limit,
or ``"cpu"``.  The JAX package's record is ``docs/ROUND3.md`` (tracking
table).  Runs on the card; without one it raises unless given
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
from piccolo_tpu_torch.device import as_tensor, resolve_device  # noqa: E402
from piccolo_tpu_torch.eval_synth import device_label  # noqa: E402
from piccolo_tpu_torch.harness.localize import _order_bounds, _pad_cloud  # noqa: E402
from piccolo_tpu_torch.init.candidates import (  # noqa: E402
    default_init_dict,
    generate_rot_points,
    generate_trans_points,
)
from piccolo_tpu_torch.pipeline import localize_query  # noqa: E402
from piccolo_tpu_torch.testing import make_scene, raycast_pano, scene_cloud  # noqa: E402
from piccolo_tpu_torch.tracking import Tracker  # noqa: E402
from piccolo_tpu_torch.utils import enable_compilation_cache  # noqa: E402


def _trajectory(n, rng, bounds=(2.2, 1.4, 1.0)):
    """~3 cm translation + ~1 deg yaw per frame, handheld-ish wobble,
    bouncing off the walls so arbitrarily long walks stay in the room."""
    ts, yprs = [], []
    t = np.array([-1.2, -0.8, 0.1], np.float32)
    v = np.float32([0.028, 0.0, 0.0])
    yaw = 0.4
    b = np.asarray(bounds, np.float32)
    for i in range(n):
        step = v + np.float32([
            0.0, 0.02 * np.sin(i / 3.0), 0.008 * np.cos(i / 4.0)
        ])
        t = t + step
        for ax in range(3):  # reflect off the walls
            if abs(t[ax]) > b[ax]:
                t[ax] = np.sign(t[ax]) * (2 * b[ax] - abs(t[ax]))
                v[ax] = -v[ax]
        yaw += 0.018 + 0.004 * float(rng.standard_normal())
        ts.append(t.copy())
        yprs.append(np.array([yaw, 0.0, 0.0], np.float32))
    return ts, yprs


def ground_truth(frames, rng, teleport=False, teleport_every=None):
    """The run's ground-truth poses, drawn from ``rng`` in the JAX script's
    order: the trajectory, then the mid-sequence teleport's offsets, then
    the second trajectory of ``teleport_every``."""
    ts, yprs = _trajectory(frames, rng)
    if teleport:
        k = frames // 2
        for i in range(k, frames):
            ts[i] = ts[i] + np.float32([1.8, 1.2, -0.2])
            yprs[i] = yprs[i] + np.float32([2.5, 0, 0])
    if teleport_every:
        # phase-alternating offset: smooth within each K-frame segment,
        # a ~1.9 m jump + big rotation at every segment boundary
        base = [t.copy() for t in _trajectory(frames, rng,
                                              bounds=(1.0, 0.6, 0.6))[0]]
        for i in range(frames):
            phase = (i // teleport_every) % 2
            off = np.float32([0.9, 0.6, 0.1]) * (1 if phase else -1)
            ts[i] = base[i] * 0.5 + off
            yprs[i] = yprs[i] + np.float32([2.5 * phase, 0, 0])
    return ts, yprs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--points", type=int, default=60000)
    ap.add_argument("--num-iter", type=int, default=30)
    ap.add_argument("--teleport", action="store_true",
                    help="teleport the camera mid-sequence to exercise "
                         "divergence recovery")
    ap.add_argument("--teleport-every", type=int, default=None,
                    help="teleport every K frames (long-horizon stability "
                         "arm: repeated losses + recoveries)")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or on the CPU")
    return ap.parse_args(argv)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    enable_compilation_cache()
    rng = np.random.default_rng(args.seed)
    scene = make_scene(rng, size=(6.0, 4.0, 3.0), n_occluders=2,
                       texture="checker")
    xyz, rgb = scene_cloud(scene, rng, args.points)
    xyz_d, rgb_d, mask_d = _pad_cloud(xyz, rgb, dev)
    lo, hi = _order_bounds(xyz, 0.05)
    lo, hi = as_tensor(lo, dev), as_tensor(hi, dev)
    res = (args.height, 2 * args.height)

    ts, yprs = ground_truth(args.frames, rng, args.teleport,
                            args.teleport_every)

    # full-pipeline recovery/seed (the reference budget)
    d = default_init_dict(xy_only=True, num_trans=50, yaw_only=True,
                          num_yaw=8, z_prior=None, num_split_h=4,
                          num_split_w=4)
    trans_grid = generate_trans_points(xyz, d)
    rot_grid = generate_rot_points(d)
    pad = (-trans_grid.shape[0]) % 64
    trans_valid = np.ones(trans_grid.shape[0] + pad, bool)
    if pad:
        trans_valid[-pad:] = False
        trans_grid = np.concatenate([trans_grid, np.zeros((pad, 3), np.float32)])
    trans_grid = as_tensor(trans_grid, dev)
    rot_grid = as_tensor(rot_grid, dev)
    trans_valid = as_tensor(trans_valid, dev)

    full_calls = []

    def full_localize(img):
        t0 = time.time()
        r = localize_query(
            img[::2, ::2].contiguous(), img, xyz_d, rgb_d, trans_grid,
            rot_grid, trans_valid, lo, hi, mask_d,
            num_intermediate=20, num_input=6, num_iter=100,
            lr=0.1, patience=5, factor=0.8, masked=True, device=dev,
        )
        t = r.t.cpu().numpy()
        full_calls.append(time.time() - t0)
        ypr = r.cand_ypr[int(r.winner)].cpu().numpy().astype(np.float32)
        return t, ypr

    img0 = as_tensor(raycast_pano(scene, ts[0], yprs[0], res), dev)
    _sync(dev)
    seed_t, seed_ypr = full_localize(img0)
    print(f"frame 0 seed (full pipeline): t_err="
          f"{np.linalg.norm(seed_t - ts[0]):.4f} m, {full_calls[0]:.2f}s",
          flush=True)

    tracker = Tracker(xyz_d, rgb_d, lo, hi, seed_t, seed_ypr,
                      point_mask=mask_d, recover=full_localize,
                      num_iter=args.num_iter, device=dev)

    times, errs, recovered_at = [], [], []
    captures_by_frame_2 = None
    for i, (t_gt, y_gt) in enumerate(zip(ts[1:], yprs[1:])):
        # render lazily (outside the timed window): a long-horizon run
        # would otherwise hold every frame in host RAM at once
        img = as_tensor(raycast_pano(scene, t_gt, y_gt, res), dev)
        _sync(dev)  # the frame is on the device before the clock starts
        t0 = time.time()
        out = tracker.update(img)
        dt = time.time() - t0
        times.append(dt)
        errs.append(float(np.linalg.norm(out.t - t_gt)))
        if out.recovered:
            recovered_at.append(i + 1)
        if i + 1 == 2:
            captures_by_frame_2 = solver.graph_stats()["captures"]
        if i < 3 or out.recovered or out.lost:
            print(f"frame {i+1}: t_err={errs[-1]*1000:.1f} mm "
                  f"{dt*1000:.1f} ms recovered={out.recovered}", flush=True)

    stats = solver.graph_stats()
    print("graphs: " + json.dumps(dict(
        captures=stats["captures"], captures_by_frame_2=captures_by_frame_2,
        recaptures=stats["recaptures"], evictions=stats["evictions"],
        graphs=[{k: g[k] for k in ("capture", "starts", "table",
                                    "table_dtype", "replays", "capture_s")
                 if k in g} for g in stats["graphs"]])),
        flush=True)

    warm_no_rec = [t for i, t in enumerate(times[2:], 3)
                   if i not in recovered_at]
    if not warm_no_rec:  # very short runs / every warm frame recovered
        warm_no_rec = times
    summary = dict(
        frames=len(times),
        height=args.height,
        num_iter=args.num_iter,
        teleport=bool(args.teleport),
        teleport_every=args.teleport_every,
        median_ms=float(np.median(warm_no_rec) * 1000),
        p90_ms=float(np.quantile(warm_no_rec, 0.9) * 1000),
        fps=float(1.0 / np.median(warm_no_rec)),
        median_t_err_mm=float(np.median(errs) * 1000),
        max_t_err_mm=float(np.max(errs) * 1000),
        n_recoveries=len(recovered_at),
        recovered_at=recovered_at[:40],
        full_pipeline_s=[round(t, 2) for t in full_calls[:40]],
        device=device_label(dev),
    )
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
