#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; each prints its seconds):
  1. device: needs CUDA; prints the card (nvidia-smi name and power limit),
     torch's version and both TF32 flags;
  2. build: compiles every CUDA kernel source of piccolo_tpu_torch with
     nvcc, one process per source, all started together;
  3. room: the bench's Stanford-scale synthetic room (60,000 points padded
     to 65,536; 50 translations x 8 yaws; 1024x512 main / 512x256 init
     images) and its slab GridPlan and HistPlan, built on the card;
  4. kernels vs their plain PyTorch versions at the main path's shapes
     (the f32 group-sum kernel on every group of the room's plan, counts
     exact and sums rtol 1e-5; block histogram bit-exact), with CUDA-event
     timings, the bound and the one-call yardstick;
  5. a small room on the card against the same query on the CPU;
  6. the library's main path: 1 warm-up and 5 timed queries through
     localize_query; median t_err must be below 0.05 m and both kernels
     (slab_group_sums_f32, block_histogram) must have launched;
  7. one more query under torch.profiler: device time per stage, the idle
     share and the heaviest kernels;
  8. the CLI's room: a ray-cast Stanford tree (1 room, 4 queries, 60,000
     points, 1024x512 panoramas) in a temporary directory, loaded as the
     CLI loads it under configs/stanford.ini;
  9. the layout kernels at the CLI's shapes: a compact and a q8 plan with
     point ids (the re-bake path) and an f32 plan (run D's) from the CLI's
     room and grids, each group-sum kernel against its plain version on
     every group with the first query's init image and colours, re-bake
     fused and unfused (counts exact, sums rtol 1e-5), group 0 timed
     against the recounted bound and the per-block count; stage 1 of a query
     (slab_pair_scores, all groups) with the fused re-bake against the
     re-bake as a separate gather (f32: into a copy of each group), in
     turns; and the masked histogram at N = 8,388,608, 524,288 and 3,001
     (bit-exact on 0/1 masks, the same bits twice on a random mask), timed
     beside an empty kernel;
 10. eight in-process runs of ``piccolo_tpu_torch.main`` on that tree with
     configs/stanford.ini:
       A  the shipped config (the ladder's own route),
       B  forced compact plan, built and saved to a plan cache,
       B' B again, loading the plan from the cache,
       C  forced q8 plan,
       D  sharpen_color off and a forced f32 plan (with a HistPlan),
       E  D's config on the gather engine and the live splat,
       F  sharpen_color off, the ladder's own choice under a plan budget
          between the q8 and the compact estimates: a q8 plan, built in
          line (the default lifecycle),
       G  as F under 0.6 of the q8 estimate: a partial q8 plan with a
          gather-engine tail, built on a background thread while the
          first query runs the gather engine;
     each must reach median t_err < 0.05 m and accuracy >= 0.75 and
     launch its kernel on every query that has a plan (run D: the f32
     kernel once a group, 9 times a query); B and C must give
     A's winners, B' B's, E D's, and F and G E's, within 1e-3 m;
then one JSON line of kernel measurements (launches from the CLI run that
drives each kernel) and, last, the device line.
"""

from __future__ import annotations

import contextlib
import csv
import glob
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SIZE = (6.0, 4.0, 3.0)
CLI_QUERIES = 4
CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                      "stanford.ini")


def log(*a):
    print(*a, flush=True)


HOST_LEAD_CYCLES = 2_000_000  # ~1 ms of sleep kernel on an H100


def cuda_ms(fn, reps=20):
    """Median device milliseconds of one call: CUDA events around each
    call, with a sleep kernel queued first so that the host enqueues the
    call while the card is still busy, and the events time the card's work
    and not the host's Python and launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(HOST_LEAD_CYCLES)
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
                lo=lo, hi=hi, trans=trans_p, trans_real=trans, rot=rot,
                valid=valid, plan=plan, hplan=hplan)


def _query_images(seed, xyz, rgb, dev):
    from piccolo_tpu_torch.testing import random_pose_inside, render_at

    gt_t, gt_ypr = random_pose_inside(np.random.default_rng(seed), SIZE)
    img_main = render_at(xyz, rgb, gt_t, gt_ypr, (512, 1024), device=dev)
    return gt_t, gt_ypr, img_main[::2, ::2].contiguous(), img_main


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# per real sample: 4 weights (6 ops), lerp (24), black test, distance and
# square sum (9), sqrt, two adds: ~42 f32 operations
F32_OPS_PER_SAMPLE = 42


def _f32_plan_stats(f, w):
    """Real samples, pad slots, blocks whose slot 0 is a pad and distinct
    windows of one f32 plan group."""
    real = (f[:, 0] >= 0) & (f[:, 6] >= 0)
    samples = int(real.sum())
    return (samples, f.shape[0] * f.shape[2] - samples,
            int((~real[:, 0]).sum()), int(torch.unique(w).numel()))


def _f32_bytes(samples, pads, nb, n_win, window, n_colours=0):
    """The bytes an f32 group's sums must move, recounted: 28 B a real
    sample (20 B and the (N, 3) colours once when the kernel re-bakes), a
    4 B probe a block, each distinct table window once, the windows and the
    (2, 128) sums; and the per-block count, kept for continuity: 8 B a pad
    slot and (nb, 2, 128) per-block partials."""
    per = 20 if n_colours else 28
    recounted = (samples * per + n_colours * 12 + nb * 4 + n_win * window * 48
                 + nb * 4 + 2 * 128 * 4)
    per_block = (samples * 28 + pads * 8 + n_win * window * 48 + nb * 4
                 + nb * 2 * 128 * 4)
    return recounted, per_block


def phase_kernels(room, dev):
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import (
        block_histogram,
        block_histogram_plain,
    )

    plan = room["plan"]
    _, _, img_init, _ = _query_images(100, room["xyz"], room["rgb"], dev)
    table = slab.slab_table(img_init, window=plan.window)
    slab_err = 0.0
    for g, (f, w) in enumerate(zip(plan.fields, plan.windows)):
        got = slab.slab_group_sums_f32(table, f, w, plan.window)
        want = slab.slab_group_sums_f32_plain(table, f, w, plan.window)
        torch.cuda.synchronize()
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"f32 slab kernel counts differ from the "
                                 f"plain version in group {g}")
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        slab_err = max(slab_err, float((got[0] - want[0]).abs().max()))
    f, w = plan.fields[0], plan.windows[0]
    nb, _, block = f.shape
    samples, pads, pad_blocks, n_win = _f32_plan_stats(f, w)
    nbytes, nbytes_blk = _f32_bytes(samples, pads, nb, n_win, plan.window)
    slab_bound, slab_by = _bound(nbytes, samples * F32_OPS_PER_SAMPLE)
    bound_blk, _ = _bound(nbytes_blk, samples * F32_OPS_PER_SAMPLE)
    slab_row = dict(
        name="slab_group_sums_f32", route="cuda",
        source="piccolo_tpu_torch/kernels/csrc/slab_sampling.cu",
        replaces="piccolo_tpu/kernels/slab_sampling.py:677",
        max_abs_err=slab_err,
        ms=cuda_ms(lambda: slab.slab_group_sums_f32(table, f, w, plan.window)),
        plain_ms=cuda_ms(lambda: slab.slab_group_sums_f32_plain(
            table, f, w, plan.window)),
        bound_ms=slab_bound, bound_by=slab_by, library_ms=None,
    )
    log(f"f32 slab kernel vs plain on all {len(plan.fields)} groups: counts "
        f"exact, max |sum err| {slab_err:.3g}; group 0 (nb={nb}, "
        f"block={block}, {samples} real samples, {pads} pad slots, "
        f"{pad_blocks} blocks with a pad slot 0, {n_win} distinct windows): "
        f"bound {slab_bound:.4f} ms ({nbytes} B recounted), {bound_blk:.4f} "
        f"ms by the per-block count ({nbytes_blk} B); the group is "
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
    bh_bound, bh_by = _bound(ids.numel() * 8 + 320 * 512 * 4, ids.numel() * 2)
    bh_row = dict(
        name="block_histogram", route="cuda",
        source="piccolo_tpu_torch/kernels/csrc/block_histogram.cu",
        replaces="piccolo_tpu/kernels/histogram_mxu.py:90",
        max_abs_err=bh_err,
        ms=cuda_ms(lambda: block_histogram(ids, mask)),
        plain_ms=cuda_ms(lambda: block_histogram_plain(ids, mask)),
        bound_ms=bh_bound, bound_by=bh_by,
        library_ms=cuda_ms(lambda: torch.bincount(
            flat, weights=mask.reshape(-1), minlength=320 * 512)),
    )
    for row in (slab_row, bh_row):
        log(f"{row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, library "
            f"{row['library_ms']})")
    return [slab_row, bh_row]


def phase_cli_room(dev, tmp):
    """The CLI's tree, and its room as the CLI loads it: cloud, candidate
    grids and the first query's init image and colours under
    configs/stanford.ini (sharpen_color on)."""
    from piccolo_tpu_torch.config import apply_overrides, cfg_get, parse_ini
    from piccolo_tpu_torch.data import read_stanford
    from piccolo_tpu_torch.harness import localize as hl
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.kernels.slab_sampling import plan_bytes_estimate
    from piccolo_tpu_torch.testing import write_synth_stanford

    tree = os.path.join(tmp, "data")
    t0 = time.time()
    write_synth_stanford(tree, rooms=1, queries=CLI_QUERIES, points=60000,
                         height=512, seed=7, oracle="raycast")
    t_write = time.time() - t0
    cfg = apply_overrides(parse_ini(CONFIG), f"data_root={tree}")
    init = hl.get_init_dict(cfg)
    hl._seed_everything()
    pcd = os.path.join(tree, "stanford", "pcd_not_aligned", "area_1",
                       "office_1.txt")
    xyz, rgb = (a.astype(np.float32)
                for a in read_stanford(pcd, cfg_get(cfg, "sample_rate", 1)))
    xyz_d, rgb_d, mask_d = hl._pad_cloud(xyz, rgb, dev)
    grids = hl._FusedGrids(xyz, init, dev)
    pano = sorted(glob.glob(os.path.join(tree, "stanford", "pano", "area_1",
                                         "*.png")))[0]
    room = dict(rgb=rgb_d, rgb_np=rgb, mask=mask_d, device=dev)
    img_init, _, rgb_used, _ = hl.prepare_stanford_images(
        cfg, imread_rgb(pano), room)
    n_pairs = grids.n_trans * int(grids.rot.shape[0])
    n_points = int(mask_d.shape[0])
    est = {k: plan_bytes_estimate(n_pairs, n_points, compact=k != "f32",
                                  quant=k == "q8")
           for k in ("f32", "compact", "q8")}
    log(f"cli tree: 1 room, {CLI_QUERIES} queries, 60000 points, 1024x512 "
        f"panos, written in {t_write:.2f} s; {n_pairs} pairs = "
        f"{-(-n_pairs // 128)} groups of 128; init image "
        f"{img_init.shape[1]}x{img_init.shape[0]}; plan estimates {est} B")
    return dict(tree=tree, xyz_d=xyz_d, rgb_d=rgb_d, mask_d=mask_d,
                grids=grids, img_init=img_init, rgb_used=rgb_used,
                n_pairs=n_pairs, groups=-(-n_pairs // 128), est=est)


def _f32_rebaked(fields, rgb):
    """A copy of an f32 plan group with its r, g and b rows re-baked from
    the colours by one gather: the route of f32 plans before the kernel
    took the colours."""
    out = fields.clone()
    out[:, 3:6] = rgb[fields[:, 7].to(torch.int64)].permute(0, 2, 1)
    return out


def _unfused_pair_scores(img, plan, rgb):
    """slab_pair_scores with the per-query re-bake done as a separate gather
    in every group (the route before the kernel took the colours): phase
    9's yardstick for the fused stage 1.  An f32 group is copied with new
    r, g and b rows, a compact or q8 group gets a new packed target
    stream."""
    from piccolo_tpu_torch.kernels import slab_sampling as slab

    table = slab.slab_table(img, wrap=plan.wrap, window=plan.window)
    scores = []
    for g, (f, w) in enumerate(zip(plan.fields, plan.windows)):
        if plan.compact:
            sums = (slab.slab_group_sums_q8 if plan.quant
                    else slab.slab_group_sums_compact)
            tps = slab.pack_rgb24(rgb)[plan.tps[g].to(torch.int64)]
            tot, cnt = sums(table, f, tps, w, plan.window)
        else:
            tot, cnt = slab.slab_group_sums_f32(table, _f32_rebaked(f, rgb), w,
                                                plan.window)
        mean = tot / cnt.clamp_min(1.0)
        scores.append(torch.where(cnt > 0, mean,
                                  torch.full_like(mean, float("inf"))))
    return torch.cat(scores)[: plan.n_pairs]


def cuda_ms_turns(fns, reps=20):
    """Median milliseconds of each of ``fns``, timed in turns (one call of
    each per round, CUDA events around each call), host overhead included:
    what a query pays."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def phase_layout_kernels(cli, dev):
    """The group-sum kernels at the CLI's shapes, and the masked histogram,
    against their plain versions, timed.  The compact and q8 plans are
    built as the CLI's forced runs B and C build them (point ids, for the
    sharpen_color re-bake) from the CLI's room and grids, and every group
    is scored with the first query's init image and colours, with the
    re-bake fused (palette) and unfused (re-baked targets).  Then stage 1
    of a query, slab_pair_scores over all 9 groups, fused against unfused
    in turns.  The same for an f32 plan (phase_f32_cli_shapes)."""
    from piccolo_tpu_torch.kernels import slab_sampling as slab

    grids = cli["grids"]
    img = torch.as_tensor(cli["img_init"], device=dev)
    H, W = img.shape[0], img.shape[1]
    rgb = cli["rgb_used"]
    palette = slab.pack_rgb24(rgb)
    rows = []
    # bytes a real sample must bring and ~f32 operations per real sample:
    # the f32 kernel's 42 plus the decode
    spec = {
        "compact": (slab.slab_group_sums_compact,
                    slab.slab_group_sums_compact_plain, 16, 54, 689),
        "q8": (slab.slab_group_sums_q8, slab.slab_group_sums_q8_plain, 8, 59,
               711),
    }
    for layout, (kernel, plain, per_real, ops_per, line) in spec.items():
        torch.cuda.synchronize()
        t0 = time.time()
        plan = slab.build_grid_plan(
            cli["xyz_d"], cli["rgb_d"], cli["mask_d"],
            grids.trans[:grids.n_trans], grids.rot, H, W, compact=True,
            tp_is_pid=True, quant=layout == "q8", device=dev)
        torch.cuda.synchronize()
        log(f"{layout} GridPlan at the CLI's shapes: {plan.nbytes} B, "
            f"{len(plan.fields)} groups x {tuple(plan.fields[0].shape)}, "
            f"window {plan.window}, block {plan.block}, built in "
            f"{time.time() - t0:.3f} s")
        table = slab.slab_table(img, window=plan.window)
        err = 0.0
        for g, (f, w, tp) in enumerate(zip(plan.fields, plan.windows,
                                           plan.tps)):
            rebaked = palette[tp.to(torch.int64)]
            for route, args in (("fused", (tp, palette)),
                                ("unfused", (rebaked, None))):
                got = kernel(table, f, args[0], w, plan.window, args[1])
                want = plain(table, f, args[0], w, plan.window, args[1])
                torch.cuda.synchronize()
                if not torch.equal(got[1], want[1]):
                    raise AssertionError(
                        f"{layout} slab kernel ({route}) counts differ from "
                        f"the plain version in group {g}")
                torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                                           atol=1e-6)
                err = max(err, float((got[0] - want[0]).abs().max()))
        f, w, tp = plan.fields[0], plan.windows[0], plan.tps[0]
        rebaked = palette[tp.to(torch.int64)]
        nb, _, block = f.shape
        if layout == "q8":
            real = ((f[:, 0] >> 23) & 0x1FF) < plan.window
        else:
            real = f[:, 0] >= 0
        samples = int(real.sum())
        pads = nb * block - samples
        pad_blocks = int((~real[:, 0]).sum())
        n_win = int(torch.unique(w).numel())
        # recounted: the real samples, a 4 B probe a block, each distinct
        # table window once, the windows, the palette once (the kernel
        # re-bakes) and the (2, 128) sums
        nbytes = (samples * per_real + nb * 4 + n_win * plan.window * 48
                  + nb * 4 + palette.numel() * 4 + 2 * 128 * 4)
        # the per-block count, kept for continuity: a pad slot's first field
        # and per-block partials
        nbytes_blk = (samples * per_real + pads * 4
                      + n_win * plan.window * 48 + nb * 4 + nb * 2 * 128 * 4)
        bound_ms, bound_by = _bound(nbytes, samples * ops_per)
        bound_blk, _ = _bound(nbytes_blk, samples * ops_per)
        ms = cuda_ms(lambda: kernel(table, f, tp, w, plan.window, palette))
        ms_unfused = cuda_ms(lambda: kernel(table, f, rebaked, w, plan.window))
        rows.append(dict(
            name=kernel.__name__, route="cuda",
            source="piccolo_tpu_torch/kernels/csrc/slab_sampling.cu",
            replaces=f"piccolo_tpu/kernels/slab_sampling.py:{line}",
            max_abs_err=err, ms=ms,
            plain_ms=cuda_ms(lambda: plain(table, f, tp, w, plan.window,
                                           palette)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        log(f"{layout} slab kernel vs plain on all {len(plan.fields)} groups, "
            f"fused and unfused: counts exact, max |sum err| {err:.3g}; "
            f"group 0 (nb={nb}, block={block}, {samples} real samples, "
            f"{pads} pad slots, {pad_blocks} blocks with a pad slot 0, "
            f"{n_win} distinct windows): fused {ms:.4f} ms, unfused "
            f"{ms_unfused:.4f} ms; bound {bound_ms:.4f} ms ({nbytes} B "
            f"recounted), {bound_blk:.4f} ms by the per-block count ({nbytes_blk} B)")
        # stage 1 of a query as slab_pair_scores runs it, all groups
        fused_q, unfused_q = cuda_ms_turns([
            lambda: slab.slab_pair_scores(img, plan, rgb),
            lambda: _unfused_pair_scores(img, plan, rgb)], reps=10)
        a = slab.slab_pair_scores(img, plan, rgb)
        b = _unfused_pair_scores(img, plan, rgb)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        log(f"{layout} stage 1 per query ({len(plan.fields)} groups, "
            f"slab_pair_scores): fused re-bake {fused_q:.4f} ms, re-bake as "
            f"a separate gather {unfused_q:.4f} ms")
        del plan, table, f, w, tp, rebaked
    phase_f32_cli_shapes(cli, dev, img, rgb)
    rows.append(phase_masked_histogram(dev))
    for row in rows:
        log(f"{row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, library "
            f"{row['library_ms']})")
    return rows


def phase_f32_cli_shapes(cli, dev, img, rgb):
    """The f32 group-sum kernel on an f32 plan built as the CLI's forced run
    D builds it: every group with the first query's colours re-baked in the
    kernel (fused) and into a copy of the group first (unfused), group 0
    timed against its recounted bound, and stage 1 of a query with the
    colours, fused against the copying route, in turns."""
    from piccolo_tpu_torch.kernels import slab_sampling as slab

    grids = cli["grids"]
    torch.cuda.synchronize()
    t0 = time.time()
    plan = slab.build_grid_plan(
        cli["xyz_d"], cli["rgb_d"], cli["mask_d"], grids.trans[:grids.n_trans],
        grids.rot, img.shape[0], img.shape[1], device=dev)
    torch.cuda.synchronize()
    log(f"f32 GridPlan at the CLI's shapes: {plan.nbytes} B, "
        f"{len(plan.fields)} groups x {tuple(plan.fields[0].shape)}, window "
        f"{plan.window}, block {plan.block}, built in {time.time() - t0:.3f} s")
    table = slab.slab_table(img, window=plan.window)
    rgb4 = slab._rgb4(rgb)
    err = 0.0
    for g, (f, w) in enumerate(zip(plan.fields, plan.windows)):
        for route, args in (("fused", (f, rgb4)),
                            ("unfused", (_f32_rebaked(f, rgb), None))):
            got = slab.slab_group_sums_f32(table, args[0], w, plan.window,
                                           args[1])
            want = slab.slab_group_sums_f32_plain(table, args[0], w,
                                                  plan.window, args[1])
            torch.cuda.synchronize()
            if not torch.equal(got[1], want[1]):
                raise AssertionError(f"f32 slab kernel ({route}) counts differ "
                                     f"from the plain version in group {g}")
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
            err = max(err, float((got[0] - want[0]).abs().max()))
        del args
    f, w = plan.fields[0], plan.windows[0]
    rebaked = _f32_rebaked(f, rgb)
    nb, _, block = f.shape
    samples, pads, pad_blocks, n_win = _f32_plan_stats(f, w)
    ops = samples * F32_OPS_PER_SAMPLE
    n_fused, _ = _f32_bytes(samples, pads, nb, n_win, plan.window,
                            rgb.shape[0])
    n_unfused, n_blk = _f32_bytes(samples, pads, nb, n_win, plan.window)
    b_fused, _ = _bound(n_fused, ops)
    b_unfused, by = _bound(n_unfused, ops)
    b_blk, _ = _bound(n_blk, ops)
    ms = cuda_ms(lambda: slab.slab_group_sums_f32(table, f, w, plan.window,
                                                  rgb4))
    ms_unfused = cuda_ms(lambda: slab.slab_group_sums_f32(table, rebaked, w,
                                                          plan.window))
    log(f"f32 slab kernel vs plain at the CLI's shapes on all "
        f"{len(plan.fields)} groups, fused and unfused: counts exact, max "
        f"|sum err| {err:.3g}; group 0 (nb={nb}, block={block}, {samples} "
        f"real samples, {pads} pad slots, {pad_blocks} blocks with a pad slot "
        f"0, {n_win} distinct windows): fused {ms:.4f} ms, bound "
        f"{b_fused:.4f} ms ({n_fused} B recounted); unfused "
        f"{ms_unfused:.4f} ms, bound {b_unfused:.4f} ms by {by} ({n_unfused} "
        f"B recounted), {b_blk:.4f} ms by the per-block count ({n_blk} B)")
    fused_q, clone_q = cuda_ms_turns([
        lambda: slab.slab_pair_scores(img, plan, rgb),
        lambda: _unfused_pair_scores(img, plan, rgb)], reps=10)
    a = slab.slab_pair_scores(img, plan, rgb)
    b = _unfused_pair_scores(img, plan, rgb)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    log(f"f32 stage 1 per query ({len(plan.fields)} groups, slab_pair_scores "
        f"with the colours): fused re-bake {fused_q:.4f} ms, re-bake into a "
        f"copy of each group {clone_q:.4f} ms")
    del plan, table, f, w, rebaked
    torch.cuda.empty_cache()


def phase_masked_histogram(dev):
    """The masked histogram against its plain version at N = 8,388,608 (a
    4096x2048 panorama), 524,288 (a 1024x512 image) and 3,001: bit-exact on
    0/1 masks, the same bits from two calls on a random-valued mask; timed
    at the first two beside an empty kernel's device time, the floor of any
    launch under cuda_ms."""
    from piccolo_tpu_torch.kernels.histogram import (
        masked_histogram_counts,
        masked_histogram_counts_plain,
    )

    g = torch.Generator(device="cpu").manual_seed(1)
    for n in (8388608, 524288, 3001):
        ids = torch.randint(-3, 530, (n,), generator=g,
                            dtype=torch.int32).to(dev)
        mask = (torch.rand((n,), generator=g) < 0.7).to(torch.float32).to(dev)
        got = masked_histogram_counts(ids, mask)
        want = masked_histogram_counts_plain(ids, mask)
        noisy = torch.rand((n,), generator=g).to(dev)
        again = [masked_histogram_counts(ids, noisy) for _ in range(2)]
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"masked histogram differs at N={n}")
        if not torch.equal(again[0], again[1]):
            raise AssertionError(f"masked histogram is not repeatable at N={n}")
        log(f"masked histogram vs plain at N={n}: bit-exact on a 0/1 mask; "
            f"two calls on a random mask give the same bits")
    empty_ms = cuda_ms(lambda: torch.cuda._sleep(0))
    rows = {}
    for n in (524288, 8388608):
        ids = torch.randint(0, 512, (n,), generator=g, dtype=torch.int32).to(dev)
        mask = (torch.rand((n,), generator=g) < 0.7).to(torch.float32).to(dev)
        ids64 = ids.to(torch.int64)
        bound_ms, bound_by = _bound(n * 8 + 512 * 4, n * 2)
        rows[n] = dict(
            name="masked_histogram_counts", route="cuda",
            source="piccolo_tpu_torch/kernels/csrc/masked_histogram.cu",
            replaces="piccolo_tpu/kernels/histogram_mxu.py:39",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: masked_histogram_counts(ids, mask)),
            plain_ms=cuda_ms(lambda: masked_histogram_counts_plain(ids, mask)),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=cuda_ms(lambda: torch.bincount(ids64, weights=mask,
                                                      minlength=512)))
        r = rows[n]
        log(f"masked histogram at N={n}, 512 bins: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, bincount {r['library_ms']:.4f}, bound "
            f"{bound_ms:.4f} by {bound_by}); an empty kernel {empty_ms:.4f} ms")
    return rows[524288]


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
    from piccolo_tpu_torch.kernels.slab_sampling import slab_group_sums_f32
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
    slab_group_sums_f32.launches = 0
    block_histogram.launches = 0
    rows = [one(200 + i) for i in range(5)]
    launches = dict(slab_group_sums_f32=slab_group_sums_f32.launches,
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

    own = {"slab_sums_kernel": "localize.stage1_loss_table",
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


def _csv_rows(log_dir):
    with open(os.path.join(log_dir, "stanford_results.csv"), newline="") as f:
        return list(csv.reader(f))[1:]


def phase_cli(cli, dev):
    """Eight runs of the CLI on the ray-cast Stanford tree; returns, per
    kernel, (launches, queries, run) of the run that drives it."""
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import block_histogram
    from piccolo_tpu_torch.kernels.histogram import masked_histogram_counts
    from piccolo_tpu_torch.main import main as cli_main

    n_q, tree, groups, est = CLI_QUERIES, cli["tree"], cli["groups"], cli["est"]
    R = int(cli["grids"].rot.shape[0])
    kernels = {fn.__name__: fn for fn in (
        slab.slab_group_sums_f32, slab.slab_group_sums_compact,
        slab.slab_group_sums_q8, block_histogram, masked_histogram_counts)}
    builds = []
    real_build = slab.build_grid_plan

    def counting_build(*a, **kw):
        builds.append((kw.get("compact"), kw.get("quant"), kw.get("nb")))
        return real_build(*a, **kw)

    # F: auto between the q8 and the compact estimates admits a full q8
    # plan; G: auto under the q8 estimate admits a partial q8 plan of the
    # leading groups that fit, built on a background thread
    cap_f = (est["q8"] + est["compact"]) // 2
    cap_g = int(est["q8"] * 0.6)
    groups_g = -(-(int(groups * cap_g / est["q8"]) * 128 // R * R) // 128)
    plans = os.path.join(os.path.dirname(tree), "plans")
    forced = "slab_init=True,slab_background_build=False"
    runs = [
        ("A", None, ""),
        ("B", "slab_group_sums_compact",
         f"{forced},slab_compact=True,slab_plan_cache=True,"
         f"slab_plan_cache_dir={plans}"),
        ("B'", "slab_group_sums_compact",
         f"{forced},slab_compact=True,slab_plan_cache=True,"
         f"slab_plan_cache_dir={plans}"),
        ("C", "slab_group_sums_q8",
         f"{forced},slab_quant=True,slab_plan_cache=False"),
        ("D", "slab_group_sums_f32",
         f"sharpen_color=False,{forced},slab_plan_cache=False"),
        ("E", "", "sharpen_color=False,slab_init=False,hist_planes=False"),
        ("F", "slab_group_sums_q8",
         f"sharpen_color=False,slab_bytes_cap={cap_f}"),
        ("G", "slab_group_sums_q8",
         f"sharpen_color=False,slab_bytes_cap={cap_g},"
         "slab_background_build=True"),
    ]
    # runs whose winners must equal another run's: the plans and kernels
    # move no winner against the gather engine and the live splat
    same_as = {"B": "A", "B'": "B", "C": "A", "E": "D", "F": "E", "G": "E"}
    out, winners = {}, {}
    slab.build_grid_plan = counting_build
    try:
        for run, slab_kernel, extra in runs:
            for fn in kernels.values():
                fn.launches = 0
            builds.clear()
            log_dir = os.path.join(os.path.dirname(tree),
                                   "log_" + run.replace("'", "p"))
            override = f"data_root={tree}" + (f",{extra}" if extra else "")
            buf = io.StringIO()
            t0 = time.time()
            try:
                with contextlib.redirect_stdout(buf):
                    acc = cli_main(["--config", CONFIG, "--log", log_dir,
                                    "--no-tensorboard", "--device", dev.type,
                                    "--override", override])
                    for t in threading.enumerate():  # plan saves, builds
                        if t.name.startswith(("piccolo-plan", "piccolo-hist")):
                            t.join()
            except Exception:
                print(buf.getvalue()[-6000:], flush=True)
                raise
            wall = time.time() - t0
            launches = {k: fn.launches for k, fn in kernels.items()}
            routes = [ln.split(":", 1)[1].strip()
                      for ln in buf.getvalue().splitlines()
                      if ln.startswith("route :")]
            rows = _csv_rows(log_dir)
            t_err = float(np.median([float(r_[7]) for r_ in rows]))
            q_s = float(np.median([float(r_[9]) for r_ in rows]))
            winners[run] = np.array([[float(v) for v in r_[5].split()]
                                     for r_ in rows])
            log(f"cli run {run}: routes {routes}; accuracy {acc}; "
                f"median t_err {t_err:.4f} m; median time (s) {q_s:.4f}; "
                f"wall {wall:.2f} s; plan builds (compact, quant, nb) "
                f"{builds}; launches {launches}; per query camera, t_err (m), "
                f"r_err (deg) "
                f"{[(r_[1][7:11], round(float(r_[7]), 4), round(float(r_[8]), 3)) for r_ in rows]}")
            if len(rows) != n_q or len(routes) != n_q:
                raise AssertionError(f"run {run}: {len(rows)} rows, "
                                     f"{len(routes)} routes")
            if not (t_err < 0.05 and acc >= 0.75):
                raise AssertionError(f"run {run}: median t_err {t_err} m, "
                                     f"accuracy {acc}")
            if launches["block_histogram"] != n_q:
                raise AssertionError(f"run {run}: block_histogram launched "
                                     f"{launches['block_histogram']} times "
                                     f"for {n_q} queries")
            want_groups = groups * n_q
            if run == "G":
                # the room's first query runs the gather engine while the
                # plan builds; the queries after it use the partial plan
                on_plan = sum("q8 slab plan (partial) + gather engine tail"
                              in r_ for r_ in routes)
                if not (on_plan >= 1 and "partial" in routes[-1]):
                    raise AssertionError(f"run G never used its partial "
                                         f"plan: {routes}")
                want_groups = groups_g * on_plan
            if run == "F" and not all(r_.startswith("stage 1 q8 slab plan,")
                                      for r_ in routes):
                raise AssertionError(f"run F did not admit a q8 plan for "
                                     f"every query: {routes}")
            if slab_kernel is not None:
                want = {k: (want_groups if k == slab_kernel else 0)
                        for k in kernels if k.startswith("slab_")}
                got = {k: v for k, v in launches.items()
                       if k.startswith("slab_")}
                if got != want:
                    raise AssertionError(f"run {run}: slab launches {got}, "
                                         f"want {want}")
            if run in ("B", "C", "D", "F") and len(builds) != 1:
                raise AssertionError(f"run {run} built {len(builds)} plans")
            if run == "B'" and builds:
                raise AssertionError("run B' rebuilt the plan instead of "
                                     "loading it from the cache")
            if run == "D" and not all("HistPlan" in r_ for r_ in routes):
                raise AssertionError(f"run D did not use a HistPlan: {routes}")
            if run in same_as:
                ref = same_as[run]
                dt = float(np.abs(winners[run] - winners[ref]).max())
                log(f"cli run {run} vs {ref}: winners within {dt:.3g} m")
                if not dt < 1e-3:
                    raise AssertionError(f"run {run}'s winners differ from "
                                         f"run {ref}'s by {dt} m")
            out[run] = launches
    finally:
        slab.build_grid_plan = real_build
    return {
        "slab_group_sums_f32": (out["D"]["slab_group_sums_f32"], n_q, "D"),
        "slab_group_sums_compact":
            (out["B"]["slab_group_sums_compact"], n_q, "B"),
        "slab_group_sums_q8": (out["C"]["slab_group_sums_q8"], n_q, "C"),
        "block_histogram": (out["A"]["block_histogram"], n_q, "A"),
    }


def timed(name, fn, *args):
    t0 = time.time()
    out = fn(*args)
    log(f"phase {name}: {time.time() - t0:.2f} s")
    return out


def main():
    timed("device", phase_device)
    dev = torch.device("cuda", 0)
    timed("build", phase_build)
    room = timed("room", phase_room, dev)
    rows = timed("kernels", phase_kernels, room, dev)
    timed("small reference", phase_small_reference, dev)
    _, median_s = timed("main path", phase_main_path, room, dev)
    timed("profile", phase_profile, room, dev, median_s)
    del room
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="piccolo_cli_")
    try:
        cli = timed("cli room", phase_cli_room, dev, tmp)
        rows += timed("layout kernels", phase_layout_kernels, cli, dev)
        torch.cuda.empty_cache()
        launched = timed("cli", phase_cli, cli, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for row in rows:
        # launches: the CLI run that drives the kernel; the masked
        # histogram runs on no query path
        n, n_q, run = launched.get(row["name"], (0, None, None))
        row["launches"] = n
        row["launches_per_query"] = None if n_q is None else n / n_q
        row["path"] = "no query path" if run is None else f"cli run {run}"
    keys = ("name", "route", "source", "replaces", "path", "launches",
            "launches_per_query", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
