#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: needs CUDA; prints the card (nvidia-smi name and power limit),
     torch's version and both TF32 flags;
  2. build: compiles the port's CUDA kernels from piccolo_tpu_torch's
     sources with nvcc, one process per source, all started together;
  3. room: the bench's Stanford-scale synthetic room (60,000 points padded
     to 65,536; 50 translations x 8 yaws; 1024x512 main / 512x256 init
     images) and its slab GridPlan and HistPlan, built on the card;
  4. kernels vs their plain PyTorch versions at the main path's shapes
     (slab counts exact and sums rtol 1e-5; block histogram bit-exact),
     with CUDA-event timings, the bound and the one-call yardstick;
  5. a small room on the card against the same query on the CPU;
  6. the main path: 1 warm-up and 5 timed queries through localize_query;
     median t_err must be below 0.05 m and both kernels must have launched;
  7. one more query under torch.profiler: device time per stage, the idle
     share and the heaviest kernels;
then one JSON line of kernel measurements and, last, the device line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SIZE = (6.0, 4.0, 3.0)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=20):
    """Median milliseconds of one call, CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rot_err_rad(R, R_gt):
    c = (np.trace(R_gt.T @ R) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from piccolo_tpu_torch.kernels._build import build_all

    t0 = time.time()
    built = build_all()
    log(f"build: {sorted(built)} in {time.time() - t0:.2f} s")


def phase_room(dev):
    from piccolo_tpu_torch import build_grid_plan, build_hist_plan
    from piccolo_tpu_torch.harness.localize import _order_bounds, _pad_cloud
    from piccolo_tpu_torch.init.candidates import (
        default_init_dict,
        generate_rot_points,
        generate_trans_points,
    )
    from piccolo_tpu_torch.kernels.slab_sampling import default_plan_bytes_cap
    from piccolo_tpu_torch.testing import make_room

    rng = np.random.default_rng(7)
    xyz, rgb = make_room(rng, n_per_wall=10000, size=SIZE, texture="checker")
    xyz_d, rgb_d, mask_d = _pad_cloud(xyz, rgb, dev)
    lo, hi = _order_bounds(xyz, 0.05)
    d = default_init_dict(xy_only=True, yaw_only=True, num_yaw=8,
                          num_split_h=4, num_split_w=4, num_trans=50,
                          z_prior=None)
    trans = generate_trans_points(xyz, d)
    rot = generate_rot_points(d)
    n_trans = trans.shape[0]
    pad = (-n_trans) % 64
    trans_p = np.concatenate([trans, np.zeros((pad, 3), np.float32)])
    valid = np.arange(n_trans + pad) < n_trans
    log(f"room: {xyz.shape[0]} points padded to {xyz_d.shape[0]}, "
        f"{n_trans} trans (padded to {n_trans + pad}) x {rot.shape[0]} yaws")

    torch.cuda.synchronize()
    t0 = time.time()
    plan = build_grid_plan(xyz_d, rgb_d, mask_d, trans, rot, 256, 512,
                           bytes_cap=default_plan_bytes_cap(dev), device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    hplan = build_hist_plan(xyz_d, rgb_d, trans, rot, 256, 512,
                            point_mask=mask_d, chunk=32, device=dev)
    torch.cuda.synchronize()
    t2 = time.time()
    log(f"GridPlan: {plan.nbytes} B, {len(plan.fields)} groups x "
        f"{tuple(plan.fields[0].shape)}, window {plan.window}, built in "
        f"{t1 - t0:.3f} s")
    log(f"HistPlan: {hplan.nbytes} B {tuple(hplan.planes.shape)}, built in "
        f"{t2 - t1:.3f} s")
    return dict(xyz=xyz, rgb=rgb, xyz_d=xyz_d, rgb_d=rgb_d, mask_d=mask_d,
                lo=lo, hi=hi, trans=trans_p, rot=rot, valid=valid, plan=plan,
                hplan=hplan)


def _query_images(seed, xyz, rgb, dev):
    from piccolo_tpu_torch.testing import random_pose_inside, render_at

    gt_t, gt_ypr = random_pose_inside(np.random.default_rng(seed), SIZE)
    img_main = render_at(xyz, rgb, gt_t, gt_ypr, (512, 1024), device=dev)
    return gt_t, gt_ypr, img_main[::2, ::2].contiguous(), img_main


def phase_kernels(room, dev):
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import (
        block_histogram,
        block_histogram_plain,
    )

    plan = room["plan"]
    _, _, img_init, _ = _query_images(100, room["xyz"], room["rgb"], dev)
    table = slab.slab_table(img_init, window=plan.window)
    f, w = plan.fields[0], plan.windows[0]
    got = slab.slab_block_partials(table, f, w, plan.window)
    want = slab.slab_block_partials_plain(table, f, w, plan.window)
    torch.cuda.synchronize()
    if not torch.equal(got[:, 1], want[:, 1]):
        raise AssertionError("slab kernel counts differ from the plain version")
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-5, atol=1e-6)
    slab_err = float((got[:, 0] - want[:, 0]).abs().max())
    nb, _, block = f.shape
    real = (f[:, 0] >= 0) & (f[:, 6] >= 0)
    samples = int(real.sum())
    pads = nb * block - samples
    pad_blocks = int((~real).all(dim=1).sum())
    n_win = int(torch.unique(w).numel())
    # the bytes the kernel must touch: 7 fields (28 B) of a real sample,
    # lidx and cid (8 B) of a pad slot, each distinct table window once,
    # the windows and the (nb, 2, 128) partials; pid is never read
    slab_bytes = (samples * 28 + pads * 8 + n_win * plan.window * 12 * 4
                  + nb * 4 + nb * 2 * 128 * 4)
    # per real sample: 4 weights (6 ops), lerp (24), black test, distance
    # and square sum (9), sqrt, two adds: ~42 f32 operations
    slab_ops = samples * 42
    slab_row = dict(
        name="slab_block_partials", route="cuda",
        source="piccolo_tpu_torch/kernels/csrc/slab_sampling.cu",
        replaces="piccolo_tpu/kernels/slab_sampling.py:677",
        max_abs_err=slab_err,
        ms=cuda_ms(lambda: slab.slab_block_partials(table, f, w, plan.window)),
        plain_ms=cuda_ms(lambda: slab.slab_block_partials_plain(
            table, f, w, plan.window)),
        bound_ms=1e3 * max(slab_bytes / HBM_BYTES_PER_S,
                           slab_ops / F32_OPS_PER_S),
        bound_by=("bytes" if slab_bytes / HBM_BYTES_PER_S
                  >= slab_ops / F32_OPS_PER_S else "operations"),
        library_ms=None,
    )
    log(f"slab kernel vs plain (one group, nb={nb}, block={block}, "
        f"{samples} real samples, {pads} pad slots, {pad_blocks} blocks all "
        f"pad, {n_win} distinct windows): counts exact, max |sum err| "
        f"{slab_err:.3g}")
    log(f"slab bound: {slab_bytes} B needed; the whole group is "
        f"{f.numel() * 4 + w.numel() * 4} B of plan")

    g = torch.Generator(device="cpu").manual_seed(0)
    bh_err = 0.0
    for B, N in ((320, 8192), (7, 3001)):
        ids = torch.randint(0, 512, (B, N), generator=g, dtype=torch.int32).to(dev)
        mask = (torch.rand((B, N), generator=g) < 0.8).to(torch.float32).to(dev)
        got = block_histogram(ids, mask)
        want = block_histogram_plain(ids, mask)
        torch.cuda.synchronize()
        bh_err = max(bh_err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"block histogram differs at {(B, N)}")
        log(f"block histogram vs plain at {(B, N)}: bit-exact")
    ids = torch.randint(0, 512, (320, 8192), generator=g,
                        dtype=torch.int32).to(dev)
    mask = (torch.rand((320, 8192), generator=g) < 0.8).to(torch.float32).to(dev)
    flat = (torch.arange(320, device=dev)[:, None] * 512 + ids).reshape(-1)
    bh_bytes = ids.numel() * 8 + 320 * 512 * 4
    bh_row = dict(
        name="block_histogram", route="cuda",
        source="piccolo_tpu_torch/kernels/csrc/block_histogram.cu",
        replaces="piccolo_tpu/kernels/histogram_mxu.py:90",
        max_abs_err=bh_err,
        ms=cuda_ms(lambda: block_histogram(ids, mask)),
        plain_ms=cuda_ms(lambda: block_histogram_plain(ids, mask)),
        bound_ms=1e3 * max(bh_bytes / HBM_BYTES_PER_S,
                           ids.numel() * 2 / F32_OPS_PER_S),
        bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.bincount(
            flat, weights=mask.reshape(-1), minlength=320 * 512)),
    )
    for row in (slab_row, bh_row):
        log(f"{row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, library "
            f"{row['library_ms']})")
    return [slab_row, bh_row]


def phase_small_reference(dev):
    """A small room localized on the card and on the CPU: same starts, same
    winner, the winner within 1e-3 m (lr 0.01: a well-conditioned descent)."""
    from piccolo_tpu_torch import build_grid_plan, build_hist_plan, localize_query
    from piccolo_tpu_torch.harness.localize import _order_bounds, _pad_cloud
    from piccolo_tpu_torch.init.candidates import (
        default_init_dict,
        generate_rot_points,
        generate_trans_points,
    )
    from piccolo_tpu_torch.testing import make_room, render_at

    rng = np.random.default_rng(21)
    xyz, rgb = make_room(rng, n_per_wall=400, texture="checker")
    img = render_at(xyz, rgb, np.array([0.4, -0.3, 0.1], np.float32),
                    np.array([2.0, 0.0, 0.0], np.float32), (64, 128),
                    device="cpu").numpy()
    d = default_init_dict(xy_only=True, num_trans=8, yaw_only=True, num_yaw=8,
                          z_prior=None, num_split_h=4, num_split_w=4)
    trans = generate_trans_points(xyz, d)[:8]
    rot = generate_rot_points(d)
    lo, hi = _order_bounds(xyz, 0.05)
    trans_p = np.concatenate([trans, np.zeros((8, 3), np.float32)])
    out = {}
    for where in ("cpu", dev):
        xyz_d, rgb_d, mask_d = _pad_cloud(xyz, rgb, where)
        plan = build_grid_plan(xyz_d, rgb_d, mask_d, trans, rot, 32, 64,
                               device=where)
        hplan = build_hist_plan(xyz_d, rgb_d, trans, rot, 32, 64,
                                point_mask=mask_d, device=where)
        res = localize_query(
            img[::2, ::2].copy(), img, xyz_d, rgb_d, trans_p, rot,
            np.arange(16) < 8, lo, hi, mask_d, num_intermediate=8,
            num_input=4, num_iter=20, lr=0.01, patience=5, factor=0.8,
            masked=True, plan=plan, hist_plan=hplan, device=where)
        out[str(where)] = res
    cpu, gpu = out["cpu"], out[str(dev)]
    if not (torch.equal(cpu.start_t, gpu.start_t.cpu())
            and torch.equal(cpu.start_ypr, gpu.start_ypr.cpu())
            and int(cpu.winner) == int(gpu.winner)):
        raise AssertionError("card and CPU selected different starts/winner")
    dt = float((cpu.t - gpu.t.cpu()).abs().max())
    if not dt < 1e-3:
        raise AssertionError(f"card and CPU winners differ by {dt} m")
    log(f"small room, card vs CPU: same starts and winner, |dt| {dt:.3g} m")


def _query(room, img_init, img_main, dev):
    from piccolo_tpu_torch import localize_query

    r = room
    return localize_query(
        img_init, img_main, r["xyz_d"], r["rgb_d"], r["trans"], r["rot"],
        r["valid"], r["lo"], r["hi"], r["mask_d"], num_intermediate=20,
        num_input=6, num_iter=100, lr=0.1, patience=5, factor=0.8,
        masked=True, plan=r["plan"], hist_plan=r["hplan"],
        descent_table="auto", device=dev)


def phase_main_path(room, dev):
    from piccolo_tpu_torch.kernels.block_histogram import block_histogram
    from piccolo_tpu_torch.kernels.slab_sampling import slab_block_partials
    from piccolo_tpu_torch.ops.rotation import rot_from_ypr

    r = room

    def one(seed):
        gt_t, gt_ypr, img_init, img_main = _query_images(
            seed, r["xyz"], r["rgb"], dev)
        torch.cuda.synchronize()
        t0 = time.time()
        res = _query(r, img_init, img_main, dev)
        t = res.t.cpu().numpy()
        elapsed = time.time() - t0
        rot = res.rot.cpu().numpy()
        if not (np.isfinite(t).all() and t.shape == (3,)
                and res.cand_loss.shape == (6,)):
            raise AssertionError("localize_query returned malformed output")
        R_gt = rot_from_ypr(torch.tensor(gt_ypr)).numpy()
        return elapsed, float(np.linalg.norm(t - gt_t)), rot_err_rad(rot, R_gt)

    one(100)  # warm-up
    slab_block_partials.launches = 0
    block_histogram.launches = 0
    rows = [one(200 + i) for i in range(5)]
    launches = dict(slab_block_partials=slab_block_partials.launches,
                    block_histogram=block_histogram.launches)
    for i, (s, te, re) in enumerate(rows):
        log(f"query {200 + i}: {s:.4f} s, t_err {te:.4f} m, "
            f"r_err {math.degrees(re):.3f} deg")
    med_s = float(np.median([r_[0] for r_ in rows]))
    med_t = float(np.median([r_[1] for r_ in rows]))
    log(f"main path: median {med_s:.4f} s/query, median t_err {med_t:.4f} m, "
        f"launches over 5 queries {launches}")
    if not med_t < 0.05:
        raise AssertionError(f"median t_err {med_t} m is not below 0.05 m")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")
    return launches, med_s


def phase_profile(room, dev, median_s):
    """One more query under torch.profiler: device busy time per stage span
    (localize.*) and for the whole query, the idle share of the query's
    wall time (profiled, and against the unprofiled median), and the
    kernels that take the most device time.  A torch op's kernels are
    charged to the span around the op; autograd runs the backward on its
    own thread, outside every span, so ops under an ``autograd::engine``
    frame are counted as the backward.  The port's own kernels are
    launched through ctypes, under no torch op, so they are charged to
    their stage by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    own = {"slab_partials_kernel": "localize.stage1_loss_table",
           "block_histogram_kernel": "localize.stage2_hist_trim"}
    _, _, img_init, img_main = _query_images(300, room["xyz"], room["rgb"], dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _query(room, img_init, img_main, dev)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6

    def add(d, key, us):
        d[key] = d.get(key, 0.0) + us

    stages, by_kernel, busy_us, n_ops = {}, {}, 0.0, 0
    for e in prof.events():
        # the spans' own device-side ranges are not device work
        if e.device_type == DeviceType.CUDA and not e.name.startswith("localize."):
            us = e.time_range.elapsed_us()
            busy_us += us
            n_ops += 1
            add(by_kernel, e.name, us)
            for key, stage in own.items():
                if key in e.name:
                    add(stages, stage, us)
        if e.device_type != DeviceType.CPU or not getattr(e, "kernels", None):
            continue
        stage, p = None, e
        while p is not None:
            if p.name.startswith("localize."):
                stage = p.name
                break
            if p.name.startswith("autograd::engine"):
                stage = "autograd backward (the descent's gradient)"
            p = p.cpu_parent
        for k in e.kernels:
            if stage and not k.name.startswith("localize.") and not any(
                    key in k.name for key in own):
                add(stages, stage, k.duration)
    if busy_us > sum(stages.values()):
        stages["outside the stage spans"] = busy_us - sum(stages.values())
    log(f"profiled query: wall {wall_us / 1e3:.1f} ms under the profiler, "
        f"{n_ops} device ops")
    if busy_us == 0:
        log("profile: torch.profiler recorded no device time (not measured)")
        return
    log(f"profile: device busy {busy_us / 1e3:.2f} ms, idle share "
        f"{1 - busy_us / wall_us:.3f} of the profiled query, "
        f"{1 - busy_us / (median_s * 1e6):.3f} of the unprofiled median")
    for name, us in sorted(stages.items(), key=lambda kv: -kv[1]):
        log(f"profile stage {name}: device {us / 1e3:.2f} ms")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile kernel {us / 1e3:8.2f} ms  {name[:100]}")


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    room = phase_room(dev)
    rows = phase_kernels(room, dev)
    phase_small_reference(dev)
    launches, median_s = phase_main_path(room, dev)
    phase_profile(room, dev, median_s)
    # launches: over the 5 timed queries of the main path's run
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_per_query"] = launches[row["name"]] / 5
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_per_query", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
