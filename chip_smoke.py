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
     exact and sums rtol 1e-5; block histogram bit-exact, on uniform ids at
     (320, 8192)), with CUDA-event timings, the bound and the one-call
     yardstick; every block-histogram row also gives its CTA threads and
     an empty kernel launched the same way, the floor of one launch's
     time;
  5. a small room on the card against the same query on the CPU;
  6. the library's main path: 1 warm-up and 5 timed queries through
     localize_query; median t_err must be below 0.05 m and both kernels
     (slab_group_sums_f32, block_histogram) must have launched; the
     warm-up's stage-2 call (coherent ids from the HistPlan) is recorded,
     and the block histogram held bit-exact and timed on it;
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
 10. nine in-process runs of ``piccolo_tpu_torch.main`` on that tree with
     configs/stanford.ini:
       A  the shipped config (the ladder's own route: one slab plan on
          every query, named by its route lines, launched once a group),
       A' A on the gather engine (slab_init = False),
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
     kernel once a group, 9 times a query); A' and B and C must give
     A's winners, B' B's, E D's, and F and G E's, within 1e-3 m;
 11. the library path with the descent's speed modes, prune (30, 2) and
     multires (70, 2), in turns with the default descent: t_err, s/query
     and the descent's device ms (profiled); this runs before phase 8, on
     phase 3's room;
 12. the OmniScenes tree: 1 ray-cast room, one handheld video of 4 frames,
     60,000 points, 2048x1024 JPEG q95 written by the port's encoder; the
     host decode of a 2048x1024 and of a 4096x2048 frame;
 13. the OmniScenes room as the CLI loads it under configs/omniscenes.ini,
     and the ladder there: the plan it admits at a 2048x1024 init image,
     the HistPlan it refuses for match_color and, with match_color off,
     admits or refuses by its budget;
 14. the kernels at the OmniScenes shapes against their plain versions: the
     f32 group sums on every group of that plan, the block histogram on
     the first frame's 50 candidates x 16 blocks of 256x512 from the live
     splat and from the HistPlan, the splat pair (kernels/splat_hist.py)
     on the same 50 candidates, the counts bit-exact; then one query's
     descent on the bf16
     table (auto) against float32: winner poses within 0.01 m, both
     localized;
 15. two CLI runs of the shipped configs/omniscenes.ini: fused (through the
     ladder, phase 13's plan whole on every query) and fused = False;
     accuracy >= 0.75 under 0.1 m / 5 deg each, the same winners within
     1e-3 m; launches counted over the fused run (the splat pair once a
     query in both: match_color keeps stage 2 on the live splat);
 16. one OmniScenes query under torch.profiler;
 17. serving (between phases 10 and 12): configs/stanford.ini in
     LocalizeService on the CLI's room, warmed at load, behind serve_forever
     on loopback; /healthz, 10 /localize requests by image_path and 1 by
     image_b64, each bit-equal to the harness's _run_fused (p50 and p90 of
     total_s); two tracked requests chained through prev_pose, one
     recover_above request that recovers; one served request under
     torch.profiler; then room = "auto" under the shipped config over the
     CLI room and a second ray-cast office loaded through /room, by a full
     query per room and with room_auto_probe = "batched" (the per-room
     probe): each query's room scores rank the rooms as ROOM_AUTO_RECORD,
     taken from both packages on the CPU, says; and the CLI room repainted
     (colours inverted), which its repainted query must pick;
 18. the device colour prep of a tracked frame at 2048x1024 on the first
     OmniScenes frame: the block histogram at (3 x 1024, 2048) and the
     masked histogram at N = 2,097,152 bit-exact against their plain
     versions and timed; color_match_device and color_mod_device through
     the kernels equal to the same on the plain versions, and within the
     JAX package's tolerances of the host color_match / color_mod;
 19. configs/omniscenes.ini with tracking = True through the CLI, and again
     with sharpen_color = True: frame 0 seed, frames 1-3 tracked with the
     device colour prep, 4/4; without sharpen_color, poses within 1e-2 m
     of phase 15's fused run;
     median time (s) of the tracked frames beside the fused median; then
     one tracked frame under torch.profiler;
 20. the descent's CUDA graph against the eager loop on phase 3's room
     (after phase 7): from one query's starts, the default 6 x 100
     descent, prune (30, 2), multires (70, 2) and trajectory bit-equal
     graphed and eager (_eager=True); then 10 queries each way in turns,
     the same winners bit for bit, s/query p50 and p90 of each;
 21. configs/stanford_parallel.ini (pitch and roll in the starts) through
     the CLI on phase 8's tree (after phase 10): route, accuracy (at least
     0.75: camera 0002 is missed by both packages, ROADMAP Queue 3), t_err
     and s/query;
 22. in phase 17, with sharpen_color = False: two services holding both
     offices, one with room_auto_probe = "batched" (the one-program probe)
     and track_batch = True, one with the per-room probe; both queries
     with room = "auto" on the two in turns, picks and score order held
     to ROOM_AUTO_RECORD, total_s p50 of each; the probes alone (the
     batched one, its loss tables, the per-room one), each profiled;
     4 concurrent tracked requests in each room until a drained batch
     (K > 1) answers within BATCH_BOUND of single requests; the graph keys
     that service used, their bytes against the graphs' cap, and no
     recapture;
 23. on the OmniScenes room (last): a tracked frame's descent graphed
     against eager, bit-equal; track_steps_batched at K = 1, 2, 4 against
     each stream's own track_step, and each batch's wall and device ms
     against K single steps; each stream of the K = 4 batch bit-equal to
     a K = 4 batch of four copies of itself.
 24. the mesh (after phase 11), on phase 3's room over make_mesh(2, 2) of
     the visible cards (four distinct cards when four are visible, every
     shard on cuda:0 when one is; each shard's card printed): the sharded
     query on every stage-1 route (f32, compact and q8 sharded plans, the
     gather engine) and both stage-2 routes (sharded HistPlan, live
     splat) against the single-device query at MESH_KW: equal starts (a
     differing start is accepted only as a stage-1 tie within
     MESH_TIE_REL, its scores printed), equal winners, cand_loss within
     MESH_LOSS_BOUND; at the full budget t_err under 0.05 m and the graphed
     descent bit-equal to the eager one; every kernel's launches on every
     card of the mesh; each kernel of the path against its plain version
     on each shard's own card at the shard's shapes (the group sums on
     every group of every shard's plan in all three layouts, the block
     histogram on the stage-2 calls the mesh queries made on each cand
     group's lead card), one kernels row per kernel with its launches and
     errors by card; 10 sharded and 10 single-device queries in turns,
     s/query p50 and p90;
 25. with two or more cards (after phase 21): configs/stanford.ini through
     the CLI with n_devices=all against one card (the route names the mesh,
     the same accuracy); LocalizeService on one card, with n_devices=all
     and with query_devices=all: 10 requests each bit-equal to _run_fused
     on its card, total_s p50/p90, requests/s from 4 concurrent clients,
     each client thread's host CPU seconds and each card's compute
     seconds under its lock;
 26. with two or more cards (last): scripts/measure_stretch.py's room
     (1.02 M points, 4096x2048) on one card and over the meshes (1, n),
     (2, n / 2) and (n, 1): each card's plan bytes before the build (the
     admitted plan must be built), s/query, t_err, peak memory by card.
 27. profile_dir (after phase 10): run D again with profile_dir set: one
     torch.profiler trace a query, run D's rows but for time, no graph
     captured or recaptured, and the slab and block-histogram kernels in
     the traces as often as their wrappers counted (a `profile_dir:` line
     of each trace's counts);
 28. the executable cache (after phase 21): two fresh CLI processes in turn
     under configs/stanford.ini with one exec_cache_dir, empty before the
     first: the first builds the five kernel libraries and the JPEG codec,
     the second loads all six and gives the first's rows bit for bit but
     for time; each one's seconds from its start to its first answer;
 29. init_distributed: two processes on the card join one group (backend
     nccl) over a localhost coordinator and run the halves of phase 28's
     sweep at once (query_shards = 2); the merged rows equal phase 28's
     one-process rows but for time.  This proves the rendezvous and the
     split, not NCCL: a sweep needs no collective, and two ranks cannot
     share one card's NCCL communicator;
 30. visualize = True through the CLI in a process where PIL cannot be
     imported: one query's GIF (the port's writer), 109 frames;
 31. profile_dir on OmniScenes (after phase 19): phase 19's sharpen_color
     tracking run again with profile_dir set: one trace a frame (the
     seed's fused query, the tracked frames with their device colour
     prep), that run's rows but for time, no graph captured or recaptured,
     and the kernels in the traces as often as their wrappers counted;
 32-35. the routing decisions, at the library room (after phase 6), the
     CLI room under the shipped stanford.ini (its ladder's plan, after
     phase 9), the OmniScenes room (after phase 14) and, on one card, the
     stretch room of phase 26 (after phase 24; its admitted plan must be
     built, whole): for each of the five values that choose the card's
     route (init.refine.gather_chunk, slab_worthwhile, the plan budget's
     fraction, resolve_plan_geometry, the descent table under auto), its
     pick and the route it refused, both timed in turns (host clock,
     synchronised); each fails when its pick takes ROUTING_SLOWER (2x)
     the other's time or more.  A `routing:` line holds every row.
 36. the synthetic accuracy evaluation (after phase 23): ``python -m
     piccolo_tpu_torch.eval_synth``'s main at 3 rooms x 2 queries in two
     arms, the Stanford profile's splat oracle with descent_table auto
     (bf16 on the card) and its ray-cast oracle with sharpen (the f32
     plan's re-bake fused); each arm must localize every query under the
     Stanford criterion, as the JAX package's records do, and launch one f32
     slab kernel a plan group a query and one stage-2 count a query (a
     block histogram of a HistPlan's planes, or the splat pair of the live
     splat; neither compact nor q8); the kernels are held against their
     plain versions at the arm's shapes.  Each summary is printed on a line.
 37-40. the measurement scripts of scripts/ (after phase 36) at a reduced
     depth, their mains and modes in this process (37-39) or in two fresh
     processes (40), each with the kernel counts set to 0 just before it
     and read just after:
 37. measure_tracking_cuda.py --frames 20 --teleport (1024x512, 60,000
     points): recovery at frame 10 alone, median t_err under 10 mm, no
     descent graph captured or recaptured after frame 2, one stage-2
     count a full query (seed and recovery; the block histogram of a
     HistPlan or the splat pair) and none a tracked frame; that kernel held
     against its plain version on the seed's stage-2 call;
 38. measure_serving_cuda.py's in-process modes, its executable cache in a
     directory of the run: sustained at 10 queries (last5 median at most
     1.5x first5), room-auto with the probe off over its four rooms x 3
     queries (12/12, each room's route printed), track-streams at 2
     streams x 4 frames with track_batch (median t_err under 0.02 m); the
     f32 group sums and stage 2's kernel held against their plain
     versions on sustained's first stage-1 and stage-2 calls;
 39. measure_plan_lifecycle_cuda.py at 60,000 points, 1024x512, 10 queries:
     --sync (the f32 plan resident from q0, one f32 launch a group a query)
     and the background default (the plan resident by the last query, the
     f32 kernel launched once it is); the f32 group sums held against
     their plain version on the --sync run's stage-1 call;
 40. measure_sharded_coldstart_cuda.py in two fresh processes on one
     executable-cache directory (60,000 points, 1024x512, a 1 x 1 mesh):
     restart false then true, every library of the second a hit, equal
     t_err, one block histogram a query counted in each process.
 41. the descent step's kernel pair (kernels/descent_step.py), after phase
     20: one more library query under torch.profiler with the pair's
     launch count zeroed first, its descent graphs' replays
     (solver.graph_stats) and the pair's kernels in its trace, which must
     equal the replays plus the wrapper's eager launches; then
     scripts/bench_descent_step.py's checks and timings at the OmniScenes
     cell's shapes (a ray-cast room of 240,000 points, dense 2048x1024
     panoramas): the pair against its plain version for every table
     dtype, wrap, mask, 6 starts, 1 start and 3 stacked streams, two runs
     of the captured step bit-equal, the 6 x 100 descent against the
     autograd step from near starts (the script's bounds), and the
     captured step timed against the same graph of the autograd step, the
     plain version and its bound: a `descent_step` row a timed shape in
     the kernels line, the 6-start row with the library query's traced
     launches and graph replays.
On one card phases 25 and 26 print that they need two cards.
Every descent above runs its captured graph (solver.py), and every
profiled query reports its kernel and graph launches.  Then the routing
rows, one line of the profiles' summaries, one line of every graph
captured (its shapes, capture s, pool and static bytes, replays), one JSON
line of kernel measurements (launches from the run that drives each
kernel) and, last, the device line.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
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
PROFILES = []  # one summary per profile_query call
GRAPHS = {}  # every descent graph captured in this run, by capture number
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SIZE = (6.0, 4.0, 3.0)
CLI_QUERIES = 4
OMNI_QUERIES = 4
ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                      "stanford.ini")
OMNI_CONFIG = os.path.join(os.path.dirname(CONFIG), "omniscenes.ini")
SERVED_REQUESTS = 10
PARALLEL_CONFIG = os.path.join(os.path.dirname(CONFIG), "stanford_parallel.ini")
PARALLEL_MIN_ACCURACY = 0.75
# a batched stream against its own track_step (m, rad): the batch's backward
# sums a stream's gradient over the cloud in another order, and the descent
# carries that ulp difference (5.3e-5 m over 30 steps on the CPU tests)
BATCH_BOUND = 1e-3
# a pruned survivor against its unpruned descent (m, rad): its second phase
# runs a batch of 2, whose reductions add in another order, and 70 steps at
# lr 0.1 carry that to 8.9e-3 on the library query (PERF.md, §6); the
# bound asks for the same basin, far inside the 0.2 m criterion
PRUNE_BOUND = 2e-2
# the mesh (phases 24-26): the JAX tests' settings for comparing a sharded
# query with one device's (tests/test_parallel.py:154-197: 12 -> 4 starts,
# 5 iterations) at lr 0.01, not their 0.1: on one H100 at lr 0.1 the f32 +
# HistPlan route gave equal starts and winner but cand_loss 8.4e-3 apart
# (PERF.md, section 6): Adam's first step moves each coordinate by lr
# times the sign of its gradient, and where a gradient is near 0 the sums'
# order sets that sign; and the one tie a differing start may be: a
# stage-1 pair that moved across the k1-th score by at most MESH_TIE_REL of
# it.  Two orders of summing n = 65,536 non-negative f32 terms give sums
# within 2 (n - 1) u of their magnitude (u = 2**-24), and the mean divides
# both by the same exact count
MESH_KW = dict(num_intermediate=12, num_input=4, num_iter=5, lr=0.01,
               patience=5, factor=0.8)
MESH_TIE_REL = 2 * 65536 * 2.0 ** -24
MESH_LOSS_BOUND = 1e-3  # cand_loss, mesh against one device (JAX's test)
MESH_QUERIES = 10
STRETCH_QUERIES = 3
MESH_ALL = "all"  # n_devices and query_devices in phases 25 and 26
# ~20 ms of sleep kernel: a tracked batch's 30 replays and table packing
# are enqueued behind it
BATCH_LEAD_CYCLES = 40_000_000
# room = "auto" (phase 17): a two-room ray-cast Stanford tree whose office_1
# and first panorama are the CLI tree's, and, per room_auto_probe mode and
# query, the room picked and the order of the room scores (a full query's
# loss, or the probe's for a room the probe ruled out) under
# configs/stanford.ini: the same in the JAX package and the port on the CPU
# (scripts/room_auto_record.py)
ROOM_AUTO_TREE = dict(rooms=2, queries=1, points=60000, height=512, seed=7,
                      oracle="raycast")
ROOM_AUTO_RECORD = {
    # room_auto_probe = "batched", sharpen_color = False: the one-program
    # probe (scripts/room_auto_record.py --modes batched --override
    # sharpen_color=False)
    "batched": {"0000synth": ("office_1.txt",
                              ["office_1.txt", "office_2.txt"]),
                "0100synth": ("office_2.txt",
                              ["office_2.txt", "office_1.txt"])},
    # room_auto_probe = True, sharpen_color = False: the per-room probe on
    # the same service config (--modes True --override sharpen_color=False)
    "True, sharpen_color=False": {
        "0000synth": ("office_1.txt", ["office_1.txt", "office_2.txt"]),
        "0100synth": ("office_2.txt", ["office_2.txt", "office_1.txt"])},
    "False": {"0000synth": ("office_1.txt", ["office_1.txt", "office_2.txt"]),
              "0100synth": ("office_2.txt", ["office_2.txt", "office_1.txt"])},
    "True": {"0000synth": ("office_1.txt", ["office_1.txt", "office_2.txt"]),
             "0100synth": ("office_2.txt", ["office_1.txt", "office_2.txt"])},
}


def log(*a):
    print(*a, flush=True)


HOST_LEAD_CYCLES = 2_000_000  # ~1 ms of sleep kernel on an H100


def cuda_ms(fn, reps=20, lead=HOST_LEAD_CYCLES):
    """Median device milliseconds of one call: CUDA events around each
    call, with a sleep kernel of ``lead`` cycles queued first so that the
    host enqueues the call while the card is still busy, and the events
    time the card's work and not the host's Python and launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(lead)
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


def _bh_extras(ids, num_bins):
    """The block histogram's launch at ids' shape: its CTA threads and the
    device ms of an empty kernel launched the same way, the floor under
    which cuda_ms cannot time one launch."""
    from piccolo_tpu_torch.kernels import block_histogram as bh

    B, N = ids.shape
    sms = torch.cuda.get_device_properties(ids.device).multi_processor_count
    with torch.cuda.device(ids.device):
        empty = cuda_ms(lambda: bh._empty_launch(B, N, num_bins, ids.device))
    return dict(threads=bh.cta_threads(B, sms), empty_launch_ms=empty)


def _run_stats(ids, mask, num_bins):
    """The share of counted entries (mask != 0, id in range) and counted
    entries a run of equal ids among consecutive entries: how coherent a
    block histogram's rows are (uniform ids give ~1 a run)."""
    v = torch.where((mask != 0) & (ids >= 0) & (ids < num_bins), ids,
                    torch.full_like(ids, -1))
    starts = torch.ones_like(v, dtype=torch.bool)
    starts[:, 1:] = v[:, 1:] != v[:, :-1]
    counted = v >= 0
    return dict(counted_share=float(counted.float().mean()),
                counted_per_run=float(counted.sum())
                / max(1, int((starts & counted).sum())))


def _recorded_bh_row(name, path, ids, mask, num_bins, launches, n_q):
    """A kernels row of the block histogram on a recorded call's inputs:
    bit-exact against the plain version, timed beside it, torch.bincount,
    the bound and an empty launch of the same geometry."""
    from piccolo_tpu_torch.kernels.block_histogram import (
        block_histogram,
        block_histogram_plain,
    )

    got = block_histogram(ids, mask, num_bins)
    want = block_histogram_plain(ids, mask, num_bins)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: block histogram differs from the "
                             f"plain version at {tuple(ids.shape)}")
    B, N = ids.shape
    # bincount's input: the same counts from in-range ids and 0/1 weights
    flat = (torch.arange(B, device=ids.device)[:, None] * num_bins
            + ids.clamp(0, num_bins - 1)).reshape(-1)
    weights = ((mask != 0) & (ids >= 0) & (ids < num_bins)).to(
        torch.float32).reshape(-1)
    bound_ms, bound_by = _bound(ids.numel() * 8 + B * num_bins * 4,
                                ids.numel() * 2)
    row = dict(
        name=name, route="cuda",
        source="piccolo_tpu_torch/kernels/csrc/block_histogram.cu",
        replaces="piccolo_tpu/kernels/histogram_mxu.py:90", path=path,
        launches=launches, launches_per_query=launches / n_q,
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(lambda: block_histogram(ids, mask, num_bins)),
        plain_ms=cuda_ms(lambda: block_histogram_plain(ids, mask, num_bins)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=cuda_ms(lambda: torch.bincount(
            flat, weights=weights, minlength=B * num_bins)),
        **_bh_extras(ids, num_bins))
    stats = _run_stats(ids, mask, num_bins)
    log(f"{name} at {(B, N)}: bit-exact; {row['ms']:.4f} ms (plain "
        f"{row['plain_ms']:.4f}, bincount {row['library_ms']:.4f}, bound "
        f"{bound_ms:.4f} by {bound_by}, empty launch "
        f"{row['empty_launch_ms']:.4f}, threads {row['threads']}); "
        f"counted {stats['counted_share']:.3f} of entries, "
        f"{stats['counted_per_run']:.2f} a run")
    return row


# stage 2's splat pair (benchmark/roofline.py's count): a projection and a
# splat, 74 operations a point and candidate; a pixel's bin test and count, 3
SPLAT_POINT_OPS, SPLAT_PIXEL_OPS = 74, 3
# sleep kernels that cover the host's launches of one stage-2 call: ~10 ms
# for the pair's 3 a chunk, ~60 ms for the plain version's ~100 a chunk
SPLAT_LEAD_CYCLES, SPLAT_PLAIN_LEAD_CYCLES = 20_000_000, 120_000_000


def _recorded_splat_row(name, path, args, launches, n_q):
    """A kernels row of stage 2's splat pair on a recorded call's arguments
    (``splat_block_counts``): block counts bit-exact against the plain
    version, timed beside it, and the bound: the cloud, its bins and mask
    and the query's pixel mask read once and the counts written once, or
    the operations of a splat a point and candidate and a count a pixel and
    candidate, the larger."""
    from piccolo_tpu_torch.kernels.splat_hist import (
        splat_block_counts,
        splat_block_counts_plain,
    )

    got = splat_block_counts(*args)
    want = splat_block_counts_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: splat block counts differ from the "
                             f"plain version at {tuple(got.shape)}")
    xyz, trans, H, W, sh, sw, chunk = (args[0], args[2], *args[6:])
    n, k = xyz.shape[0], trans.shape[0]
    bound_ms, bound_by = _bound(
        n * 17 + H * W + k * sh * sw * 512 * 4,
        k * (n * SPLAT_POINT_OPS + H * W * SPLAT_PIXEL_OPS))
    row = dict(
        name=name, route="cuda",
        source="piccolo_tpu_torch/kernels/csrc/splat_hist.cu",
        replaces="none: the JAX package's splat is an XLA scatter-min",
        path=path, launches=launches, launches_per_query=launches / n_q,
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(lambda: splat_block_counts(*args),
                   lead=SPLAT_LEAD_CYCLES),
        plain_ms=cuda_ms(lambda: splat_block_counts_plain(*args), reps=5,
                         lead=SPLAT_PLAIN_LEAD_CYCLES),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    log(f"{name}: {k} candidates x {n} points at {H}x{W} in {sh} x {sw} "
        f"blocks, chunks of {chunk}: bit-exact; {row['ms']:.4f} ms (plain "
        f"{row['plain_ms']:.4f}, bound {bound_ms:.4f} by {bound_by})")
    return row


def _stage2_rows(key, path, stage2, splats, counts, n_q):
    """The kernels rows of the stage-2 calls a run recorded: the block
    histogram's on its first recorded call (a HistPlan's planes), the splat
    pair's on its first (the live splat)."""
    rows = []
    if stage2:
        (_, _, nbins), (ids, mask) = next(iter(stage2.items()))
        rows.append(_recorded_bh_row(f"block_histogram.{key}", path, ids,
                                     mask, nbins, counts["block_histogram"],
                                     n_q))
    if splats:
        rows.append(_recorded_splat_row(
            f"splat_block_counts.{key}", path, next(iter(splats.values())),
            counts["splat_block_counts"], n_q))
    return rows


def _stage2_calls(counts):
    """Stage 2's calls in a run's wrapper counts: a block histogram of a
    HistPlan's planes or one live splat through the kernel pair a query
    (the configs these runs use prepare their colours without the block
    histogram)."""
    return counts["block_histogram"] + counts["splat_block_counts"]


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
        **_bh_extras(ids, 512),
    )
    for row in (slab_row, bh_row):
        log(f"{row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, library "
            f"{row['library_ms']}"
            + (f", at (320, 8192) on uniform ids, {row['threads']} threads "
               f"a CTA, an empty kernel launched the same way "
               f"{row['empty_launch_ms']:.4f} ms" if row is bh_row else "")
            + ")")
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
    img_init, img_main, rgb_used, _ = hl.prepare_stanford_images(
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
                n_pairs=n_pairs, groups=-(-n_pairs // 128), est=est, cfg=cfg,
                img_main=img_main, bounds=hl._order_bounds(xyz, 0.05))


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


def _query(room, img_init, img_main, dev, **kw):
    from piccolo_tpu_torch import localize_query

    r = room
    return localize_query(
        img_init, img_main, r["xyz_d"], r["rgb_d"], r["trans"], r["rot"],
        r["valid"], r["lo"], r["hi"], r["mask_d"], num_intermediate=20,
        num_input=6, num_iter=100, lr=0.1, patience=5, factor=0.8,
        masked=True, plan=r["plan"], hist_plan=r["hplan"],
        descent_table="auto", device=dev, **kw)


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

    stage2 = {}
    with _recording_stage2(stage2):
        one(100)  # warm-up, its stage-2 call recorded
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
    # the library query's own stage-2 call: coherent ids from the HistPlan
    (_, _, nbins), (ids, mask) = next(iter(stage2.items()))
    bh_row = _recorded_bh_row(
        "block_histogram.library", "library main path (phase 6), 5 queries",
        ids, mask, nbins, launches["block_histogram"], 5)
    return launches, med_s, bh_row


BACKWARD = "autograd backward (the descent's gradient)"


def cpu_op_stages(raw):
    """The stage of each torch op in ``raw`` (torch.profiler's raw kineto
    events), by its correlation id: the innermost ``localize.*`` span that
    encloses it on its thread, else the backward when an ``autograd::engine``
    frame encloses it, else None.  This is the walk up ``cpu_parent`` that
    torch.profiler's event tree allows, from one sorted pass a thread: that
    tree takes tens of seconds to build for a query's ~60k device ops.
    Also the stage around each runtime call (a kernel or a graph launch), by
    the call's own correlation id, which its device work shares: a CUDA
    graph's kernels are linked to their cudaGraphLaunch and to no op."""
    from torch.autograd import DeviceType

    threads = {}
    for e in raw:
        if e.device_type() == DeviceType.CPU:
            threads.setdefault(e.start_thread_id(), []).append(e)
    stage_of, stage_of_call = {}, {}
    for evs in threads.values():
        evs.sort(key=lambda e: (e.start_ns(), -e.end_ns()))
        stack = []  # (end_ns, stage) of the ops that enclose the next one
        for e in evs:
            while stack and stack[-1][0] <= e.start_ns():
                stack.pop()
            up = stack[-1][1] if stack else None
            name = e.name()
            # runtime calls carry the id of the op that made them, if any
            if e.linked_correlation_id() != 0 or name.startswith("cu"):
                stage_of_call[e.correlation_id()] = up
                continue
            if name.startswith("localize."):
                stage = name
            elif up is not None and up.startswith("localize."):
                stage = up
            elif name.startswith("autograd::engine"):
                stage = BACKWARD
            else:
                stage = up
            stage_of[e.correlation_id()] = stage
            stack.append((e.end_ns(), stage))
    return stage_of, stage_of_call


def profile_query(label, run, median_s):
    """One call of ``run`` (a query) under torch.profiler: device busy time
    per stage span (localize.*) and for the whole query, the idle share of
    the query's wall time (profiled, and against the unprofiled median
    ``median_s``), and the kernels that take the most device time.  A torch
    op's kernels are charged to the span around the op; autograd runs the
    backward on its own thread, outside every span, so ops under an
    ``autograd::engine`` frame are counted as the backward
    (``cpu_op_stages``).  The port's own kernels are launched through
    ctypes, under no torch op, so they are charged to their stage by name.
    Returns the stages' device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    own = {"slab_sums_kernel": "localize.stage1_loss_table",
           "block_histogram_kernel": "localize.stage2_hist_trim",
           "splat_keys_kernel": "localize.stage2_hist_trim",
           "dilate_block_hist_kernel": "localize.stage2_hist_trim"}
    launch_calls = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx")
    graph_calls = ("cudaGraphLaunch", "cuGraphLaunch")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6

    def add(d, key, us):
        d[key] = d.get(key, 0.0) + us

    raw = prof.profiler.kineto_results.events()
    stage_of, stage_of_call = cpu_op_stages(raw)
    stages, by_kernel, busy_us, n_ops = {}, {}, 0.0, 0
    by_card = {}  # device busy us by card
    n_launch = n_graph = 0
    graph_host_us = 0.0
    windows = {}  # stage -> (first start, last end) of its device work, ns
    first, last = math.inf, 0
    for e in raw:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            n_launch += name in launch_calls
            n_graph += name in graph_calls
            if name in graph_calls:
                graph_host_us += e.duration_ns() / 1e3
        # the spans' own device-side ranges are not device work
        if e.device_type() != DeviceType.CUDA or name.startswith("localize."):
            continue
        us = e.duration_ns() / 1e3
        busy_us += us
        add(by_card, e.device_index(), us)
        n_ops += 1
        first = min(first, e.start_ns())
        last = max(last, e.start_ns() + e.duration_ns())
        add(by_kernel, name, us)
        stage = next((s_ for key, s_ in own.items() if key in name), None)
        if stage is None:
            stage = stage_of.get(e.linked_correlation_id())
        if stage is None:
            stage = stage_of_call.get(e.correlation_id())
        if stage:
            add(stages, stage, us)
            lo_, hi_ = windows.get(stage, (math.inf, 0))
            windows[stage] = (min(lo_, e.start_ns()),
                              max(hi_, e.start_ns() + e.duration_ns()))
    # a mesh's cards work side by side: idle shares are the busiest card's
    busy_card_us = max(by_card.values(), default=0.0)
    if busy_us > sum(stages.values()):
        stages["outside the stage spans"] = busy_us - sum(stages.values())
    log(f"{label} profiled query: wall {wall_us / 1e3:.1f} ms under the "
        f"profiler, {n_ops} device ops; launches: {n_launch} kernels and "
        f"{n_graph} graphs ({graph_host_us / 1e3:.2f} ms of host time in the "
        f"graph launches)")
    PROFILES.append(dict(label=label, device_ops=n_ops,
                         kernel_launches=n_launch, graph_launches=n_graph,
                         graph_launch_host_ms=graph_host_us / 1e3,
                         busy_ms=busy_us / 1e3, profiled_wall_ms=wall_us / 1e3,
                         busy_ms_by_card={k: v / 1e3
                                          for k, v in sorted(by_card.items())},
                         median_s=median_s,
                         device_window_ms=(last - first) / 1e6
                         if n_ops else None,
                         idle_share=(1 - busy_card_us / (median_s * 1e6))
                         if busy_us else None))
    if busy_us == 0:
        log(f"{label} profile: torch.profiler recorded no device time (not "
            "measured)")
        return {}
    if len(by_card) > 1:
        log(f"{label} profile: device busy by card (ms) "
            f"{ {k: round(v / 1e3, 2) for k, v in sorted(by_card.items())} }")
    log(f"{label} profile: device busy {busy_us / 1e3:.2f} ms in a window of "
        f"{(last - first) / 1e6:.2f} ms from the first kernel's start to the "
        f"last's end; idle share (of the busiest card) "
        f"{1 - busy_card_us / wall_us:.3f} of the profiled query, "
        f"{1 - busy_card_us / (median_s * 1e6):.3f} of the unprofiled median")
    for name, us in sorted(stages.items(), key=lambda kv: -kv[1]):
        w = windows.get(name)
        log(f"{label} profile stage {name}: device {us / 1e3:.2f} ms"
            + ("" if w is None else f" in a window of "
               f"{(w[1] - w[0]) / 1e6:.2f} ms from its first kernel's start "
               f"to its last's end"))
    w = windows.get("localize.stage3_descent")
    if w is not None:
        PROFILES[-1]["descent_busy_ms"] = stages[
            "localize.stage3_descent"] / 1e3
        PROFILES[-1]["descent_window_ms"] = (w[1] - w[0]) / 1e6
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"{label} profile kernel {us / 1e3:8.2f} ms  {name[:100]}")
    return {k: us / 1e3 for k, us in stages.items()}


def phase_profile(room, dev, median_s):
    """One more library query under torch.profiler (profile_query)."""
    _, _, img_init, img_main = _query_images(300, room["xyz"], room["rgb"], dev)
    profile_query("library", lambda: _query(room, img_init, img_main, dev),
                  median_s)


def _csv_rows(log_dir):
    with open(os.path.join(log_dir, "stanford_results.csv"), newline="") as f:
        return list(csv.reader(f))[1:]


def phase_cli(cli, dev):
    """Eight runs of the CLI on the ray-cast Stanford tree; returns, per
    kernel, (launches, queries, run) of the run that drives it."""
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import block_histogram
    from piccolo_tpu_torch.kernels.histogram import masked_histogram_counts
    from piccolo_tpu_torch.kernels.splat_hist import splat_block_counts
    from piccolo_tpu_torch.main import main as cli_main

    n_q, tree, groups, est = CLI_QUERIES, cli["tree"], cli["groups"], cli["est"]
    R = int(cli["grids"].rot.shape[0])
    kernels = {fn.__name__: fn for fn in (
        slab.slab_group_sums_f32, slab.slab_group_sums_compact,
        slab.slab_group_sums_q8, block_histogram, masked_histogram_counts,
        splat_block_counts)}
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
        ("A'", "", "slab_init=False"),
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
    same_as = {"A'": "A", "B": "A", "B'": "B", "C": "A", "E": "D", "F": "E",
               "G": "E"}
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
            if _stage2_calls(launches) != n_q:
                raise AssertionError(f"run {run}: stage 2 ran "
                                     f"{launches['block_histogram']} block "
                                     "histograms and "
                                     f"{launches['splat_block_counts']} "
                                     f"live splats for {n_q} queries")
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
            if run == "A":
                # the shipped config's own route: the plan the ladder admits
                # on every query (a build that fails falls back to the
                # gather engine, which fails here), one launch a group
                layout = routes[0].split()[2] if routes else None
                if layout not in ("f32", "compact", "q8") or not all(
                        r_.startswith(f"stage 1 {layout} slab plan,")
                        for r_ in routes):
                    raise AssertionError(f"run A did not take one slab plan "
                                         f"on every query: {routes}")
                slab_kernel = f"slab_group_sums_{layout}"
            if run == "A'" and not all(r_.startswith("stage 1 gather engine")
                                       for r_ in routes):
                raise AssertionError(f"run A' left the gather engine: "
                                     f"{routes}")
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
    f32_run = "A" if out["A"]["slab_group_sums_f32"] else "D"
    return {
        "slab_group_sums_f32":
            (out[f32_run]["slab_group_sums_f32"], n_q, f32_run),
        "slab_group_sums_compact":
            (out["B"]["slab_group_sums_compact"], n_q, "B"),
        "slab_group_sums_q8": (out["C"]["slab_group_sums_q8"], n_q, "C"),
        # run D's HistPlan planes; run A's live splat runs the splat pair
        "block_histogram": (out["D"]["block_histogram"], n_q, "D"),
    }


# the port's kernels by their __global__ names in a trace, and the wrappers
# that launch them
OWN_KERNELS = {"slab_sums_kernel": "slab_group_sums_f32",
               "block_histogram_kernel": "block_histogram",
               "masked_histogram_kernel": "masked_histogram_counts"}
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
GRAPH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")
# run D of phase 10: sharpen_color off, a forced f32 plan and a HistPlan
RUN_D = ("sharpen_color=False,slab_init=True,slab_background_build=False,"
         "slab_plan_cache=False")


def _trace_counts(path):
    """One Chrome trace of utils.maybe_trace: the port's kernels' device
    launches by wrapper, all kernel events, and the host's kernel and graph
    launch calls."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    own = dict.fromkeys(OWN_KERNELS.values(), 0)
    n_kernels = n_launch = n_graph = 0
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "kernel":
            n_kernels += 1
            for key, wrapper in OWN_KERNELS.items():
                own[wrapper] += key in name
        elif cat in ("cuda_runtime", "cuda_driver"):
            n_launch += name in LAUNCH_CALLS
            n_graph += name in GRAPH_CALLS
    return dict(own=own, device_kernels=n_kernels, kernel_launches=n_launch,
                graph_launches=n_graph)


def phase_cli_profile(cli, dev):
    """Run D of phase 10 again with profile_dir: one trace a query, the rows
    of run D but for time, no graph captured or recaptured, and the port's
    kernels counted in the traces as often as their wrappers counted."""
    from piccolo_tpu_torch import solver
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import block_histogram
    from piccolo_tpu_torch.kernels.histogram import masked_histogram_counts
    from piccolo_tpu_torch.main import main as cli_main

    base = os.path.dirname(cli["tree"])
    traces = os.path.join(base, "traces")
    log_dir = os.path.join(base, "log_D_profiled")
    wrappers = {"slab_group_sums_f32": slab.slab_group_sums_f32,
                "block_histogram": block_histogram,
                "masked_histogram_counts": masked_histogram_counts}
    for fn in wrappers.values():
        fn.launches = 0
    before = solver.graph_stats()
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            cli_main(["--config", CONFIG, "--log", log_dir,
                      "--no-tensorboard", "--device", dev.type, "--override",
                      f"data_root={cli['tree']},{RUN_D},profile_dir={traces}"])
    except Exception:
        print(buf.getvalue()[-6000:], flush=True)
        raise
    wall = time.time() - t0
    after = solver.graph_stats()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    rows = _csv_rows(log_dir)
    ref = _csv_rows(os.path.join(base, "log_D"))
    names = sorted(glob.glob(os.path.join(traces, "*.pt.trace.json")))
    counts = [_trace_counts(p) for p in names]
    in_traces = {k: sum(c["own"][k] for c in counts) for k in wrappers}
    log(f"cli profile_dir (run D): {len(names)} traces, "
        f"{sum(os.path.getsize(p) for p in names)} B, wall {wall:.2f} s; "
        f"captures {after['captures'] - before['captures']}, recaptures "
        f"{after['recaptures'] - before['recaptures']}; wrapper launches "
        f"{launches}; in the traces {in_traces}")
    log("profile_dir: " + json.dumps(
        [dict(trace=os.path.basename(p), **c) for p, c in zip(names, counts)]))
    if len(names) != CLI_QUERIES:
        raise AssertionError(f"{len(names)} traces for {CLI_QUERIES} queries")
    if [r_[:9] for r_ in rows] != [r_[:9] for r_ in ref]:
        raise AssertionError("the profiled run's rows differ from run D's: "
                             f"{rows} against {ref}")
    if (after["captures"], after["recaptures"]) != (before["captures"],
                                                    before["recaptures"]):
        raise AssertionError("the profiled run captured or recaptured a "
                             f"graph: {before} -> {after}")
    if in_traces != launches or not launches["slab_group_sums_f32"]:
        raise AssertionError(f"kernels in the traces {in_traces}, launched "
                             f"{launches}")
    return counts


def _first_answer_run(cmd, env, timeout=600):
    """Run a CLI process; returns (rc, its output, seconds from its start to
    its first answer (the first ``min_index`` line), wall seconds)."""
    t0 = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT)
    watchdog = threading.Timer(timeout, proc.kill)
    watchdog.start()
    first, lines = None, []
    try:
        for ln in proc.stdout:
            lines.append(ln)
            if first is None and ln.startswith("min_index :"):
                first = time.time() - t0
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, "".join(lines), first, time.time() - t0


def _child_env():
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def phase_exec_cache(tree, dev):
    """Two fresh CLI processes in turn under configs/stanford.ini with one
    exec_cache_dir, empty before the first: the first builds the five
    kernel libraries and the JPEG codec, the second loads all six (hits)
    and gives the first's rows bit for bit but for time.  Returns the
    first's rows (the one-process sweep of phase 29)."""
    base = os.path.dirname(tree)
    exec_dir = os.path.join(base, "exec_cache")
    runs = []
    for i in range(2):
        log_dir = os.path.join(base, f"log_exec{i}")
        rc, out, first, wall = _first_answer_run(
            [sys.executable, "-m", "piccolo_tpu_torch.main", "--config",
             CONFIG, "--log", log_dir, "--no-tensorboard", "--device",
             dev.type, "--override",
             f"data_root={tree},exec_cache_dir={exec_dir}"], _child_env())
        if rc != 0:
            print(out[-6000:], flush=True)
            raise AssertionError(f"exec-cache process {i} exited {rc}")
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("exec cache: "))
        rows = _csv_rows(log_dir)
        runs.append(dict(line=line, first=first, wall=wall, rows=rows,
                         first_query_s=float(rows[0][9])))
        log(f"exec cache process {i}: {line}; first answer {first:.2f} s "
            f"after the process started (its query {rows[0][9]} s), wall "
            f"{wall:.2f} s for {len(rows)} queries")
    n_libs = 6 if dev.type == "cuda" else 1  # the CPU builds only the codec
    if f"0 hit(s), {n_libs} built" not in runs[0]["line"]:
        raise AssertionError(f"the first process did not build: {runs[0]}")
    if f"{n_libs} hit(s), 0 built, 0 rebuilt" not in runs[1]["line"]:
        raise AssertionError(f"the second process did not hit: {runs[1]}")
    if [r_[:9] for r_ in runs[0]["rows"]] != [r_[:9] for r_ in runs[1]["rows"]]:
        raise AssertionError("the exec-cache hit changed the rows")
    log("exec cache: " + json.dumps(
        {f"process {i}": dict(first_answer_s=r_["first"], wall_s=r_["wall"],
                              first_query_s=r_["first_query_s"],
                              cache=r_["line"]) for i, r_ in enumerate(runs)}))
    return runs[0]["rows"]


_DIST_WORKER = """
import sys
idx, coord, cfg, log, override, device = sys.argv[1:7]
idx = int(idx)
import torch.distributed as dist
from piccolo_tpu_torch.parallel import init_distributed

got = init_distributed(coord, 2, idx, device=device)  # the card: nccl
assert got == idx == dist.get_rank(), (got, idx)
assert dist.get_world_size() == 2
assert dist.get_backend() == ("nccl" if device == "cuda" else "gloo")
from piccolo_tpu_torch.main import main

main(["--config", cfg, "--log", log, "--no-tensorboard", "--device", device,
      "--override",
      f"{override},query_shards=2,query_shard_index={got}"])
# both halves written: a barrier over the coordinator (on one card two
# ranks cannot share an NCCL communicator, so it is a gloo group's)
dist.barrier(group=dist.new_group(backend="gloo"))
dist.destroy_process_group()
print("WORKER_OK", idx, flush=True)
"""


def phase_distributed(tree, one_process, dev):
    """init_distributed in two processes on the card (nccl, a localhost
    coordinator), each running half of the stanford.ini sweep of phase 28
    at once: the merged rows equal phase 28's one-process rows but for
    time."""
    import socket

    base = os.path.dirname(tree)
    worker = os.path.join(base, "dist_worker.py")
    with open(worker, "w") as f:
        f.write(_DIST_WORKER)
    s_ = socket.socket()
    s_.bind(("localhost", 0))
    coord = f"localhost:{s_.getsockname()[1]}"
    s_.close()
    logs, procs = [], []
    for idx in range(2):
        logs.append(os.path.join(base, f"log_dist{idx}"))
        procs.append(subprocess.Popen(
            [sys.executable, worker, str(idx), coord, CONFIG, logs[-1],
             f"data_root={tree}", dev.type], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=_child_env(), cwd=ROOT))
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=600)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for idx, (out, rc) in enumerate(outs):
        if rc != 0 or f"WORKER_OK {idx}" not in out:
            print(out[-6000:], flush=True)
            raise AssertionError(f"distributed worker {idx} exited {rc}")
    shards = [_csv_rows(d) for d in logs]
    merged = sorted((r_ for rows in shards for r_ in rows),
                    key=lambda r_: r_[1])
    want = sorted(one_process, key=lambda r_: r_[1])
    log(f"init_distributed: 2 processes ({dev.type}) on {coord}, "
        f"{[len(r_) for r_ in shards]} queries each, times (s) "
        f"{[[r_[9] for r_ in rows] for rows in shards]}")
    if not all(shards) or len(merged) != len(want):
        raise AssertionError(f"shards {shards} against {len(want)} rows")
    if [r_[:9] for r_ in merged] != [r_[:9] for r_ in want]:
        raise AssertionError("the merged sweep differs from the one-process "
                             f"sweep: {merged} against {want}")


_GIF_WORKER = """
import sys
sys.modules["PIL"] = None  # no PIL: importing it raises
tree, cfg, log, device = sys.argv[1:5]
from piccolo_tpu_torch.main import main

main(["--config", cfg, "--log", log, "--no-tensorboard", "--device", device,
      "--override",
      f"data_root={tree},visualize=True,query_shards=4,query_shard_index=0"])
print("WORKER_OK", flush=True)
"""


def _gif_frames_in(data: bytes) -> int:
    """The image descriptors of a GIF89a, walking its blocks."""
    if data[:6] != b"GIF89a" or data[-1:] != b"\x3b":
        raise AssertionError("not a GIF89a file")

    def skip(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    flags = data[10]
    pos = 13 + (3 * (2 << (flags & 7)) if flags & 0x80 else 0)
    n = 0
    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            pos = skip(pos + 2)
        elif data[pos] == 0x2C:
            n += 1
            local = data[pos + 9]
            pos += 10 + (3 * (2 << (local & 7)) if local & 0x80 else 0)
            pos = skip(pos + 1)
        else:
            raise AssertionError(f"unknown GIF block {data[pos]:#x}")
    return n


def phase_gif(tree, dev):
    """visualize = True through the CLI in a process without PIL: the
    query's optimisation GIF, 4 lead copies + 100 iterations + 5 holds."""
    base = os.path.dirname(tree)
    worker = os.path.join(base, "gif_worker.py")
    with open(worker, "w") as f:
        f.write(_GIF_WORKER)
    log_dir = os.path.join(base, "log_gif")
    t0 = time.time()
    proc = subprocess.run([sys.executable, worker, tree, CONFIG, log_dir,
                           dev.type],
                          capture_output=True, text=True, env=_child_env(),
                          cwd=ROOT, timeout=600)
    if proc.returncode != 0 or "WORKER_OK" not in proc.stdout:
        print((proc.stdout + proc.stderr)[-6000:], flush=True)
        raise AssertionError(f"the visualize run exited {proc.returncode}")
    gifs = sorted(glob.glob(os.path.join(log_dir, "gifs", "*", "*.gif")))
    if len(gifs) != 1:
        raise AssertionError(f"visualize wrote {gifs}")
    with open(gifs[0], "rb") as f:
        data = f.read()
    n = _gif_frames_in(data)
    log(f"visualize gif without PIL: {os.path.relpath(gifs[0], log_dir)}, "
        f"{len(data)} B, {n} frames, {time.time() - t0:.2f} s")
    if n != 4 + 100 + 5:
        raise AssertionError(f"{n} GIF frames, want 109")


def phase_speed_modes(room, dev):
    """The library path with the descent's speed modes, prune (30, 2) and
    multires (70, 2), against the default descent: after a warm-up of each,
    5 rounds of one query per mode in turns (t_err and s/query medians),
    then one query of each mode under torch.profiler for the descent's
    device ms (its forward and Adam span plus the backward)."""
    from piccolo_tpu_torch.ops.rotation import rot_from_ypr

    modes = {"default": {}, "prune (30, 2)": dict(descent_prune=(30, 2)),
             "multires (70, 2)": dict(descent_multires=(70, 2))}

    def one(seed, kw):
        gt_t, gt_ypr, img_init, img_main = _query_images(
            seed, room["xyz"], room["rgb"], dev)
        torch.cuda.synchronize()
        t0 = time.time()
        res = _query(room, img_init, img_main, dev, **kw)
        t = res.t.cpu().numpy()
        elapsed = time.time() - t0
        if not (np.isfinite(t).all() and res.cand_loss.shape == (6,)):
            raise AssertionError(f"{kw}: malformed output")
        R_gt = rot_from_ypr(torch.tensor(gt_ypr)).numpy()
        return (elapsed, float(np.linalg.norm(t - gt_t)),
                rot_err_rad(res.rot.cpu().numpy(), R_gt))

    for kw in modes.values():
        one(100, kw)
    rows = {name: [] for name in modes}
    for i in range(5):
        for name, kw in modes.items():
            rows[name].append(one(200 + i, kw))
    out = {}
    _, _, img_init, img_main = _query_images(300, room["xyz"], room["rgb"], dev)
    for name, kw in modes.items():
        med_s = float(np.median([r_[0] for r_ in rows[name]]))
        med_t = float(np.median([r_[1] for r_ in rows[name]]))
        descent = fwd = None
        if kw:  # phase 7 profiled the default descent
            stages = profile_query(
                f"library {name}",
                lambda: _query(room, img_init, img_main, dev, **kw), med_s)
            fwd = stages.get("localize.stage3_descent", 0.0)
            descent = fwd + stages.get(
                BACKWARD, 0.0)
        log(f"library {name}: median {med_s:.4f} s/query, median t_err "
            f"{med_t:.4f} m; per query s "
            f"{[round(r_[0], 4) for r_ in rows[name]]}, t_err (m) "
            f"{[round(r_[1], 4) for r_ in rows[name]]}"
            + ("" if descent is None else
               f"; descent device {descent:.2f} ms (forward and Adam "
               f"{fwd:.2f}, backward {descent - fwd:.2f})"))
        out[name] = dict(s=med_s, t_err=med_t, descent_ms=descent)
    return out


def host_ms(fn, reps):
    """Median host milliseconds of ``reps`` calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_omni_tree(tmp):
    """The OmniScenes tree: 1 ray-cast room (6x4x3 m, 2 occluders, floor at
    z = 0), one handheld video of OMNI_QUERIES frames, 60,000 points,
    2048x1024 panoramas written as JPEG q95 by the port's encoder.  Then the
    host decode of one of its frames, and of a 4096x2048 frame of the same
    kind of room, each the median of a few calls."""
    from piccolo_tpu_torch.data import omniscenes_pano_glob
    from piccolo_tpu_torch.harness.imaging import jpeg_decode, jpeg_encode
    from piccolo_tpu_torch.testing import (
        make_scene,
        raycast_pano,
        scene_pose,
        write_synth_omniscenes,
    )

    tree = os.path.join(tmp, "omni")
    t0 = time.time()
    write_synth_omniscenes(tree, rooms=1, queries=OMNI_QUERIES, points=60000,
                           height=1024, seed=7, oracle="raycast")
    t_write = time.time() - t0
    panos = sorted(glob.glob(omniscenes_pano_glob(tree)))
    with open(panos[0], "rb") as f:
        frame = f.read()
    rng = np.random.default_rng(8)
    scene = make_scene(rng, size=SIZE, n_occluders=2, floor_at_zero=True)
    t, ypr = scene_pose(scene, rng, z_range=(1.3, 1.7))
    t0 = time.time()
    big = jpeg_encode((raycast_pano(scene, t, ypr, (2048, 4096))
                       * 255).astype(np.uint8))
    t_big = time.time() - t0
    decode = {"2048x1024": host_ms(lambda: jpeg_decode(frame), 5),
              "4096x2048": host_ms(lambda: jpeg_decode(big), 3)}
    if jpeg_decode(big).shape != (2048, 4096, 3):
        raise AssertionError("the 4096x2048 frame decoded to the wrong shape")
    log(f"omniscenes tree: {len(panos)} frames (2048x1024 JPEG q95, "
        f"{len(frame)} B the first) written in {t_write:.2f} s; a 4096x2048 "
        f"frame ({len(big)} B) ray-cast and encoded in {t_big:.2f} s; host "
        f"decode ms (median) {decode}; host cores {os.cpu_count()}")
    return dict(tree=tree, decode_ms=decode)


def phase_omni_room(dev, omni):
    """The OmniScenes room as the CLI loads it under configs/omniscenes.ini:
    the cloud, the candidate grids and the first frame's images (match_color
    at 2048x1024, then the resizes; the init image stays 2048x1024).  Then
    the ladder's decisions there: the stage-1 plan it admits (built in line
    and timed), the HistPlan it refuses for match_color, and the HistPlan
    it admits or refuses by its budget with match_color off (built and
    timed when admitted)."""
    from piccolo_tpu_torch.config import apply_overrides, cfg_get, parse_ini
    from piccolo_tpu_torch.data import omniscenes_pano_glob, read_omniscenes
    from piccolo_tpu_torch.harness import localize as hl
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.init.refine import hist_plan_bytes
    from piccolo_tpu_torch.kernels.slab_sampling import (
        default_plan_bytes_cap,
        plan_bytes_estimate,
    )

    tree = omni["tree"]
    cfg = apply_overrides(parse_ini(OMNI_CONFIG), f"data_root={tree}")
    init = hl.get_init_dict(cfg)
    hl._seed_everything()
    pcd = glob.glob(os.path.join(tree, "omniscenes", "pcd", "*.txt"))[0]
    room = hl._load_room(read_omniscenes, pcd, cfg_get(cfg, "sample_rate", 1),
                         0.05, dev, init)
    panos = sorted(glob.glob(omniscenes_pano_glob(tree)))
    raw = imread_rgb(panos[0])
    t0 = time.time()
    orig, img_init, img_main, rgb_used, _ = hl.prepare_omniscenes_images(
        cfg, raw, room)
    t_prep = time.time() - t0
    grids = room["grids"]
    n_pairs = grids.n_trans * int(grids.rot.shape[0])
    n_points = int(room["mask"].shape[0])
    cap = default_plan_bytes_cap(dev)
    adm = hl._slab_admission(cfg, room, grids, img_init)
    torch.cuda.synchronize()
    t0 = time.time()
    plan = hl._maybe_slab_plan(cfg, room, grids, img_init, sync=True)
    torch.cuda.synchronize()
    t_plan = time.time() - t0
    if plan is None:
        raise AssertionError(f"the ladder admitted no plan at 2 Mpx: {adm}")
    layout = "q8" if plan.quant else ("compact" if plan.compact else "f32")
    shipped_hist = hl._maybe_hist_plan(cfg, room, grids, img_init, sync=True)
    if shipped_hist is not None:
        raise AssertionError("match_color must keep the HistPlan off")
    cfg_off = apply_overrides(cfg, "match_color=False")
    need = hist_plan_bytes(n_pairs, *img_init.shape[:2])
    slab_est = plan_bytes_estimate(n_pairs, n_points, compact=plan.compact)
    side = dict(room)  # the HistPlan is cached here, and dropped with it
    torch.cuda.synchronize()
    t0 = time.time()
    hplan = hl._maybe_hist_plan(cfg_off, side, grids, img_init, sync=True)
    torch.cuda.synchronize()
    t_hist = time.time() - t0
    log(f"omniscenes room: {int(room['mask'].sum())} points padded to "
        f"{n_points}; {grids.n_trans} translations x {grids.rot.shape[0]} "
        f"yaws = {n_pairs} pairs, {-(-n_pairs // 128)} groups; init image "
        f"{img_init.shape[1]}x{img_init.shape[0]}, main "
        f"{img_main.shape[1]}x{img_main.shape[0]}; first frame's prep "
        f"(match_color and resizes) {t_prep:.2f} s on the host")
    log(f"omniscenes ladder: admission {adm}; {layout} plan {plan.nbytes} B "
        f"(window {plan.window}, block {plan.block}) built in {t_plan:.3f} s; "
        f"plan cap {cap} B; HistPlan under the shipped config: refused "
        f"(match_color); with match_color off it needs {need} B + the plan's "
        f"estimate {slab_est} B against {cap} B: "
        + (f"admitted, {hplan.nbytes} B built in {t_hist:.3f} s"
           if hplan is not None else "refused"))
    return dict(cfg=cfg, room=room, img_init=img_init, img_main=img_main,
                rgb_used=rgb_used, plan=plan, hplan=hplan, gt=panos[0],
                n_pairs=n_pairs, layout=layout)


def phase_omni_kernels(o, dev):
    """The kernels at the OmniScenes shapes against their plain versions:
    the plan's group-sum kernel on every group (counts exact, sums rtol
    1e-5), group 0 timed against its recounted bound; the block histogram
    on the first frame's 50 stage-2 candidates x 16 blocks of 256x512
    pixels from the live splat (bit-exact), timed against its bound and
    torch.bincount, and again from the HistPlan's planes; the splat pair
    that now counts the live splat's blocks on the main path, on the same
    50 candidates (bit-exact), timed against its bound and the plain
    version.  Then the bf16
    descent table (auto at 2048x1024) against float32 on one query: winner
    poses within 0.01 m and both within 0.1 m of the truth."""
    from piccolo_tpu_torch import localize_query
    from piccolo_tpu_torch.data import obtain_gt_omniscenes
    from piccolo_tpu_torch.init.refine import (
        _NB,
        _point_bins,
        _query_side,
        _splat_bins,
    )
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import (
        block_histogram,
        block_histogram_plain,
    )
    from piccolo_tpu_torch.kernels.splat_hist import bin_rows
    from piccolo_tpu_torch.ops.sampling import resolve_descent_table

    plan, room = o["plan"], o["room"]
    if plan.compact:
        raise AssertionError("the OmniScenes plan was expected in the f32 "
                             f"layout, got {o['layout']}")
    img = torch.as_tensor(o["img_init"], device=dev)
    H, W = img.shape[0], img.shape[1]
    table = slab.slab_table(img, window=plan.window)
    err = 0.0
    for g, (f, w) in enumerate(zip(plan.fields, plan.windows)):
        got = slab.slab_group_sums_f32(table, f, w, plan.window)
        want = slab.slab_group_sums_f32_plain(table, f, w, plan.window)
        torch.cuda.synchronize()
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"f32 slab kernel counts differ from the "
                                 f"plain version in OmniScenes group {g}")
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        err = max(err, float((got[0] - want[0]).abs().max()))
    f, w = plan.fields[0], plan.windows[0]
    nb, _, block = f.shape
    samples, pads, pad_blocks, n_win = _f32_plan_stats(f, w)
    nbytes, _ = _f32_bytes(samples, pads, nb, n_win, plan.window)
    bound, by = _bound(nbytes, samples * F32_OPS_PER_SAMPLE)
    slab_row = dict(
        name="slab_group_sums_f32.omniscenes", route="cuda",
        source="piccolo_tpu_torch/kernels/csrc/slab_sampling.cu",
        replaces="piccolo_tpu/kernels/slab_sampling.py:677",
        max_abs_err=err,
        ms=cuda_ms(lambda: slab.slab_group_sums_f32(table, f, w, plan.window)),
        plain_ms=cuda_ms(lambda: slab.slab_group_sums_f32_plain(
            table, f, w, plan.window), reps=5),
        bound_ms=bound, bound_by=by, library_ms=None)
    log(f"omniscenes f32 slab kernel vs plain on all {len(plan.fields)} "
        f"groups: counts exact, max |sum err| {err:.3g}; group 0 (nb={nb}, "
        f"block={block}, {samples} real samples, {pads} pad slots, "
        f"{pad_blocks} blocks with a pad slot 0, {n_win} distinct windows): "
        f"{slab_row['ms']:.4f} ms, bound {bound:.4f} ms ({nbytes} B "
        f"recounted)")

    # stage 1's top 50 pairs, then their live splat as stage 2 bins it
    grids = room["grids"]
    T, R = grids.trans.shape[0], grids.rot.shape[0]
    scores = slab.slab_pair_scores(img, plan)
    scores = torch.cat([scores, torch.full((T * R - plan.n_pairs,), math.inf,
                                           device=dev)])
    k1 = int(o["cfg"].num_intermediate)
    idx = torch.sort(scores, stable=True).indices[:k1]
    pair_t, pair_r = slab.make_pairs(grids.trans, grids.rot)
    t1, r1 = pair_t[idx], pair_r[idx]
    q = _query_side(img, 4, 4)
    rgb_bins = _point_bins(room["rgb"], _NB)
    pbin = torch.cat([_splat_bins(room["xyz"], rgb_bins, t1[c:c + 4],
                                  r1[c:c + 4], room["mask"], H, W)
                      for c in range(0, k1, 4)])

    def rows_of(pbin):
        return bin_rows(pbin, q.pix_ok, *q.grid)

    ids, msk = rows_of(pbin)
    del pbin
    got = block_histogram(ids, msk)
    want = block_histogram_plain(ids, msk)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"block histogram differs at {tuple(ids.shape)}")
    B, N = ids.shape
    flat = (torch.arange(B, device=dev)[:, None] * _NB + ids).reshape(-1)
    bh_bound, bh_by = _bound(ids.numel() * 8 + B * _NB * 4, ids.numel() * 2)
    bh_row = dict(
        name="block_histogram.omniscenes", route="cuda",
        source="piccolo_tpu_torch/kernels/csrc/block_histogram.cu",
        replaces="piccolo_tpu/kernels/histogram_mxu.py:90",
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(lambda: block_histogram(ids, msk)),
        plain_ms=cuda_ms(lambda: block_histogram_plain(ids, msk), reps=5),
        bound_ms=bh_bound, bound_by=bh_by,
        library_ms=cuda_ms(lambda: torch.bincount(
            flat, weights=msk.reshape(-1), minlength=B * _NB), reps=5),
        **_bh_extras(ids, _NB))
    del flat
    stats = _run_stats(ids, msk, _NB)
    log(f"omniscenes block histogram vs plain at {(B, N)} from the live "
        f"splat of {k1} candidates: bit-exact; {bh_row['ms']:.4f} ms (plain "
        f"{bh_row['plain_ms']:.4f}, bincount {bh_row['library_ms']:.4f}, "
        f"bound {bh_bound:.4f} by {bh_by}, {ids.numel() * 8 + B * _NB * 4} B, "
        f"empty launch {bh_row['empty_launch_ms']:.4f}, threads "
        f"{bh_row['threads']}); counted {stats['counted_share']:.3f} of "
        f"entries, {stats['counted_per_run']:.2f} a run")
    if o["hplan"] is not None:
        hp = o["hplan"]
        planes = hp.planes[idx.clamp_max(hp.n_pairs - 1)].to(torch.int32)
        hids, hmsk = rows_of(planes)
        # pixels where both sides agree on the bin, or both mask it out
        same = float((((hids == ids) & (hmsk == msk)) | ((hmsk == 0) & (msk == 0)))
                     .to(torch.float32).mean())
        got = block_histogram(hids, hmsk)
        torch.cuda.synchronize()
        if not torch.equal(got, block_histogram_plain(hids, hmsk)):
            raise AssertionError("block histogram differs on HistPlan planes")
        log(f"omniscenes block histogram from the HistPlan's planes: "
            f"bit-exact against plain, {cuda_ms(lambda: block_histogram(hids, hmsk)):.4f} "
            f"ms; bins equal to the live splat's at {same:.6f} of pixels")
        del planes, hids, hmsk
    del ids, msk, got, want
    o["hplan"] = None
    torch.cuda.empty_cache()
    splat_row = _recorded_splat_row(
        "splat_block_counts.omniscenes", f"stage 2 of {k1} candidates",
        (room["xyz"], rgb_bins, t1, r1, room["mask"], q.pix_ok, H, W, 4, 4,
         4), 0, 1)

    # the bf16 descent table (auto at 2048x1024) against float32
    gt_t, _ = obtain_gt_omniscenes(o["gt"])
    cfg = o["cfg"]
    res = {}
    for table_dtype in ("auto", "float32"):
        r = localize_query(
            o["img_init"], o["img_main"], room["xyz"], o["rgb_used"],
            grids.trans, grids.rot, grids.valid, room["lo"], room["hi"],
            room["mask"], num_intermediate=cfg.num_intermediate,
            num_input=cfg.num_input, num_split_h=4, num_split_w=4,
            num_iter=cfg.num_iter, lr=cfg.lr, patience=cfg.patience,
            factor=cfg.factor, masked=True, plan=plan,
            descent_table=table_dtype, device=dev)
        res[table_dtype] = (int(r.winner), r.t.cpu().numpy())
    dt = float(np.abs(res["auto"][1] - res["float32"][1]).max())
    errs = {k: float(np.linalg.norm(v[1] - gt_t.ravel())) for k, v in res.items()}
    log(f"omniscenes descent table: auto resolves to "
        f"{resolve_descent_table('auto', *o['img_main'].shape[:2], dev)}; "
        f"winner {res['auto'][0]} (bf16) / {res['float32'][0]} (f32), "
        f"winners {dt:.4g} m apart, t_err {errs}")
    # two starts can descend into the same basin, so the winner's index may
    # flip between the tables while its pose stays put: hold the poses
    if not (dt < 0.01 and max(errs.values()) < 0.1):
        raise AssertionError(f"bf16 and f32 descent tables disagree: {res}, "
                             f"t_err {errs}")
    return [slab_row, bh_row, splat_row]


def _omni_csv(log_dir):
    with open(os.path.join(log_dir, "omniscenes_results.csv"), newline="") as f:
        return list(csv.reader(f))[1:]


def phase_omni_cli(omni, dev, layout):
    """The shipped configs/omniscenes.ini through the CLI on the OmniScenes
    tree, fused (through the ladder) and with fused = False; each must reach
    accuracy >= 0.75 under 0.1 m / 5 deg, and the two runs' winners must
    agree within 1e-3 m; the fused run must score stage 1 on the ``layout``
    plan phase 13 admitted, whole, on every query (a plan build that fails
    falls back to the gather engine).  Returns the fused run's launches per
    kernel."""
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import block_histogram
    from piccolo_tpu_torch.kernels.splat_hist import splat_block_counts
    from piccolo_tpu_torch.main import main as cli_main

    kernels = {fn.__name__: fn for fn in (
        slab.slab_group_sums_f32, slab.slab_group_sums_compact,
        slab.slab_group_sums_q8, block_histogram, splat_block_counts)}
    n_q, out, winners = OMNI_QUERIES, {}, {}
    for run, extra in (("fused", ""), ("staged", ",fused=False")):
        for fn in kernels.values():
            fn.launches = 0
        log_dir = os.path.join(os.path.dirname(omni["tree"]), "log_omni_" + run)
        buf = io.StringIO()
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(buf):
                acc = cli_main(["--config", OMNI_CONFIG, "--log", log_dir,
                                "--no-tensorboard", "--device", dev.type,
                                "--override", f"data_root={omni['tree']}{extra}"])
        except Exception:
            print(buf.getvalue()[-6000:], flush=True)
            raise
        wall = time.time() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        routes = [ln.split(":", 1)[1].strip()
                  for ln in buf.getvalue().splitlines()
                  if ln.startswith("route :")]
        rows = _omni_csv(log_dir)
        winners[run] = np.array([[float(v) for v in r_[4].split()]
                                 for r_ in rows])
        t_err = [round(float(r_[6]), 4) for r_ in rows]
        r_err = [round(float(r_[7]), 3) for r_ in rows]
        q_s = float(np.median([float(r_[8]) for r_ in rows]))
        log(f"omniscenes cli {run}: routes {routes}; accuracy {acc}; t_err "
            f"(m) {t_err}; r_err (deg) {r_err}; median time (s) {q_s:.4f}; "
            f"wall {wall:.2f} s; launches {launches}")
        if len(rows) != n_q or len(routes) != n_q:
            raise AssertionError(f"omniscenes {run}: {len(rows)} rows, "
                                 f"{len(routes)} routes")
        if not acc >= 0.75:
            raise AssertionError(f"omniscenes {run}: accuracy {acc}")
        # match_color refuses a HistPlan: every query's stage 2 is the
        # live splat, the kernel pair once a query
        if (launches["splat_block_counts"], launches["block_histogram"]) != (
                n_q, 0):
            raise AssertionError(f"omniscenes {run}: the splat pair ran "
                                 f"{launches['splat_block_counts']} times and "
                                 f"the block histogram "
                                 f"{launches['block_histogram']} for {n_q} "
                                 "queries")
        if run == "fused" and not all(
                r_.startswith(f"stage 1 {layout} slab plan,")
                for r_ in routes):
            raise AssertionError(f"omniscenes fused: routes {routes}, not the "
                                 f"{layout} plan on every query")
        out[run] = dict(launches=launches, routes=routes, s=q_s, acc=acc,
                        winners=winners[run])
    dt = float(np.abs(winners["fused"] - winners["staged"]).max())
    log(f"omniscenes cli fused vs staged: winners within {dt:.3g} m")
    if not dt < 1e-3:
        raise AssertionError(f"fused and staged winners differ by {dt} m")
    f32 = out["fused"]["launches"]["slab_group_sums_f32"]
    if f32 == 0 or out["staged"]["launches"]["slab_group_sums_f32"]:
        raise AssertionError(f"the f32 kernel launched {f32} times fused and "
                             f"{out['staged']['launches']['slab_group_sums_f32']} "
                             "staged")
    return out


def phase_omni_profile(o, dev, median_s):
    """One OmniScenes query of the fused path (the room's plan, the first
    frame) under torch.profiler."""
    from piccolo_tpu_torch import localize_query

    room, cfg = o["room"], o["cfg"]
    grids = room["grids"]

    def run():
        localize_query(
            o["img_init"], o["img_main"], room["xyz"], o["rgb_used"],
            grids.trans, grids.rot, grids.valid, room["lo"], room["hi"],
            room["mask"], num_intermediate=cfg.num_intermediate,
            num_input=cfg.num_input, num_split_h=4, num_split_w=4,
            num_iter=cfg.num_iter, lr=cfg.lr, patience=cfg.patience,
            factor=cfg.factor, masked=True, plan=o["plan"], device=dev)

    run()  # warm-up
    profile_query("omniscenes", run, median_s)


def phase_omni_colour(o, dev):
    """The device colour prep of a tracked frame at 2048x1024, on the
    OmniScenes frame already loaded: the block histogram at the rows
    color_match_device gives it ((3 x 1024, 2048) ids, 256 bins) and the
    masked histogram at the Y ids color_mod_device gives it (N = 2,097,152,
    256 bins), each bit-exact against its plain version, timed against its
    bound and torch.bincount; both functions through the kernels against
    the same functions on the plain versions (equal images) and against the
    host color_match / color_mod (the JAX package's test tolerances, 1e-5
    and 1.001/255); both functions' device ms."""
    from piccolo_tpu_torch import color
    from piccolo_tpu_torch.color import _rgb2ycrcb_i32
    from piccolo_tpu_torch.convert import cdf_from_numpy, sharpen_state_from_numpy
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.harness.localize import resize_ablate_omniscenes
    from piccolo_tpu_torch.kernels import block_histogram as bh
    from piccolo_tpu_torch.kernels import histogram as mh

    room = o["room"]
    orig = resize_ablate_omniscenes(o["cfg"], imread_rgb(o["gt"]))
    img_np = orig.astype(np.float32) / 255.0
    img = torch.as_tensor(img_np, device=dev)
    H, W, _ = img.shape
    rgb_np = room["rgb_np"]
    cdf = cdf_from_numpy(color.cloud_color_cdf(rgb_np), dev)
    st = sharpen_state_from_numpy(color.cloud_sharpen_state(
        rgb_np, pad_to=int(room["mask"].shape[0])), dev)

    # the kernels' inputs, as the two functions build them
    img_i = (img * 255).to(torch.int32)
    nonblack = img_i.sum(-1) > 0
    ids = img_i.permute(2, 0, 1).reshape(3 * H, W).contiguous()
    msk = nonblack.to(torch.float32).repeat(3, 1).contiguous()
    y = _rgb2ycrcb_i32(img_i, xp=torch).to(torch.int32)[..., 0]
    y = y.reshape(-1).contiguous()
    w = nonblack.reshape(-1).to(torch.float32).contiguous()
    got_b, want_b = bh.block_histogram(ids, msk, 256), bh.block_histogram_plain(ids, msk, 256)
    got_m = mh.masked_histogram_counts(y, w, 256)
    want_m = mh.masked_histogram_counts_plain(y, w, 256)
    torch.cuda.synchronize()
    if not (torch.equal(got_b, want_b) and torch.equal(got_m, want_m)):
        raise AssertionError("a histogram kernel differs from its plain "
                             "version on the tracked frame")
    B, N = ids.shape
    flat = (torch.arange(B, device=dev)[:, None] * 256 + ids).reshape(-1)
    y64 = y.to(torch.int64)
    rows = []
    for name, fn, plain, nbytes, n_in, lib, line, src in (
            ("block_histogram", lambda: bh.block_histogram(ids, msk, 256),
             lambda: bh.block_histogram_plain(ids, msk, 256),
             ids.numel() * 8 + B * 256 * 4, ids.numel(),
             lambda: torch.bincount(flat, weights=msk.reshape(-1),
                                    minlength=B * 256), 90,
             "block_histogram.cu"),
            ("masked_histogram_counts",
             lambda: mh.masked_histogram_counts(y, w, 256),
             lambda: mh.masked_histogram_counts_plain(y, w, 256),
             y.numel() * 8 + 256 * 4, y.numel(),
             lambda: torch.bincount(y64, weights=w, minlength=256), 39,
             "masked_histogram.cu")):
        bound_ms, bound_by = _bound(nbytes, n_in * 2)
        rows.append(dict(
            name=f"{name}.tracked", route="cuda",
            source=f"piccolo_tpu_torch/kernels/csrc/{src}",
            replaces=f"piccolo_tpu/kernels/histogram_mxu.py:{line}",
            max_abs_err=0.0, ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=cuda_ms(lib)))
    rows[0].update(_bh_extras(ids, 256))
    stats = _run_stats(ids, msk, 256)
    for r in rows:
        log(f"tracked-frame {r['name']}: bit-exact; {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, bincount {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}"
            + (f", empty launch {r['empty_launch_ms']:.4f}, threads "
               f"{r['threads']}; counted {stats['counted_share']:.3f} of "
               f"entries, {stats['counted_per_run']:.2f} a run"
               if "threads" in r else "") + ")")
    del flat, y64

    matched = color.color_match_device(img, *cdf)
    sharp, cloud = color.color_mod_device(img, st)
    real_b, real_m = bh.block_histogram, mh.masked_histogram_counts
    bh.block_histogram = bh.block_histogram_plain
    mh.masked_histogram_counts = mh.masked_histogram_counts_plain
    try:
        matched_p = color.color_match_device(img, *cdf)
        sharp_p, cloud_p = color.color_mod_device(img, st)
    finally:
        bh.block_histogram, mh.masked_histogram_counts = real_b, real_m
    if not (torch.equal(matched, matched_p) and torch.equal(sharp, sharp_p)
            and torch.equal(cloud, cloud_p)):
        raise AssertionError("the device colour functions differ between "
                             "the kernels and their plain versions")
    n = rgb_np.shape[0]
    d_match = float(np.abs(matched.cpu().numpy()
                           - color.color_match(img_np.copy(), rgb_np)).max())
    h_img, h_rgb = color.color_mod(img_np.copy(), rgb_np, 256)
    d_img = float(np.abs(sharp.cpu().numpy() - h_img).max())
    d_rgb = float(np.abs(cloud[:n].cpu().numpy() - h_rgb).max())
    if not (d_match < 1e-5 and d_img <= 1.001 / 255 and d_rgb <= 1.001 / 255
            and bool(torch.all(cloud[n:] == 0))):
        raise AssertionError(f"device colour against the host: match "
                             f"{d_match}, sharpen image {d_img}, cloud {d_rgb}")
    ms_match = cuda_ms(lambda: color.color_match_device(img, *cdf))
    ms_mod = cuda_ms(lambda: color.color_mod_device(img, st))
    log(f"device colour at {W}x{H}: kernels and plain versions give equal "
        f"images; against the host |match| {d_match:.3g}, |sharpen| image "
        f"{d_img:.3g} cloud {d_rgb:.3g}; color_match_device {ms_match:.4f} "
        f"ms, color_mod_device {ms_mod:.4f} ms (device, per frame)")
    return rows


def phase_omni_tracking(omni, dev, fused):
    """configs/omniscenes.ini with tracking = True through the CLI on the
    OmniScenes video, then again with sharpen_color = True (the masked
    histogram's query path): frame 0 seed, frames 1-3 tracked with the
    device colour prep, 4/4 localized; without sharpen_color every pose
    within 1e-2 m of the fused run's (phase 15).  Returns each run's
    launches, those made in the tracked frames' colour prep, and the median
    s of its tracked frames."""
    from piccolo_tpu_torch import tracking as T
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import block_histogram
    from piccolo_tpu_torch.kernels.histogram import masked_histogram_counts
    from piccolo_tpu_torch.kernels.splat_hist import splat_block_counts
    from piccolo_tpu_torch.main import main as cli_main

    kernels = {fn.__name__: fn for fn in (
        slab.slab_group_sums_f32, slab.slab_group_sums_compact,
        slab.slab_group_sums_q8, block_histogram, masked_histogram_counts,
        splat_block_counts)}
    # the launches made inside the tracked frames' colour prep, apart from
    # the seed frame's stage 2: each kernel's own count, read around the
    # two colour functions
    colour = {"block_histogram": 0, "masked_histogram_counts": 0}

    def counted(fn, kernel):
        def wrapped(*a, **kw):
            n = kernels[kernel].launches
            try:
                return fn(*a, **kw)
            finally:
                colour[kernel] += kernels[kernel].launches - n
        return wrapped

    real = T.color_match_device, T.color_mod_device
    T.color_match_device = counted(real[0], "block_histogram")
    T.color_mod_device = counted(real[1], "masked_histogram_counts")
    out = {}
    try:
        for run, extra in (("tracking", ""), ("tracking, sharpen_color",
                                              ",sharpen_color=True")):
            out[run] = _omni_tracking_run(omni, dev, fused, cli_main,
                                          kernels, colour, run, extra)
    finally:
        T.color_match_device, T.color_mod_device = real
    return out


def _omni_tracking_run(omni, dev, fused, cli_main, kernels, colour, run,
                       extra):
    """One tracking CLI run of phase_omni_tracking."""
    for fn in kernels.values():
        fn.launches = 0
    for k in colour:
        colour[k] = 0
    log_dir = os.path.join(os.path.dirname(omni["tree"]),
                           "log_omni_" + run.replace(", ", "_"))
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            acc = cli_main(["--config", OMNI_CONFIG, "--log", log_dir,
                            "--no-tensorboard", "--device", dev.type,
                            "--override", f"data_root={omni['tree']},"
                            f"tracking=True{extra}"])
    except Exception:
        print(buf.getvalue()[-6000:], flush=True)
        raise
    wall = time.time() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    text = buf.getvalue()
    modes = [ln.split(":", 1)[1].strip() for ln in text.splitlines()
             if ln.startswith("tracking :")]
    routes = [ln.split(":", 1)[1].strip() for ln in text.splitlines()
              if ln.startswith("route :")]
    rows = _omni_csv(log_dir)
    poses = np.array([[float(v) for v in r_[4].split()] for r_ in rows])
    secs = [float(r_[8]) for r_ in rows]
    dt = float(np.abs(poses - fused["winners"]).max())
    tracked_s = float(np.median(secs[1:]))
    log(f"omniscenes cli {run}: modes {modes}; routes {routes}; accuracy "
        f"{acc}; t_err (m) {[round(float(r_[6]), 4) for r_ in rows]}; "
        f"time (s) {[round(v, 4) for v in secs]}; median tracked frame "
        f"{tracked_s:.4f} s against the fused run's median query "
        f"{fused['s']:.4f} s; poses within {dt:.3g} m of the fused run's; "
        f"wall {wall:.2f} s; launches {launches}")
    if modes != ["seed"] + ["tracked"] * (OMNI_QUERIES - 1):
        raise AssertionError(f"omniscenes {run}: modes {modes}")
    if not all("device colour prep" in r_ for r_ in routes[1:]):
        raise AssertionError(f"omniscenes {run}: tracked frames without "
                             f"the device colour prep: {routes}")
    # sharpen_color changes every frame's colours, so only the run
    # without it is held to the fused run's poses
    if not (acc == 1.0 and (extra or dt < 1e-2)):
        raise AssertionError(f"omniscenes {run}: accuracy {acc}, poses "
                             f"{dt} m from the fused run's")
    # the splat pair in the seed's stage 2; color_match_device of each
    # tracked frame; color_mod_device of each tracked frame
    tracked = OMNI_QUERIES - 1
    want_bh, want_mh = tracked, (tracked if extra else 0)
    if ((launches["block_histogram"], launches["masked_histogram_counts"],
         launches["splat_block_counts"]) != (want_bh, want_mh, 1)
            or colour != {"block_histogram": tracked,
                          "masked_histogram_counts": want_mh}):
        raise AssertionError(f"omniscenes {run}: launches {launches}, in "
                             f"the tracked frames' colour prep {colour}")
    return dict(launches=launches, colour=dict(colour),
                tracked_s=tracked_s)


def phase_omni_cli_profile(omni, dev):
    """The sharpen_color tracking run of phase 19 again with profile_dir:
    one trace a frame (the seed's fused query, the tracked frames with
    their device colour prep), that run's rows but for time, no graph
    captured or recaptured, and the port's kernels counted in the traces
    as often as their wrappers counted."""
    from piccolo_tpu_torch import solver
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import block_histogram
    from piccolo_tpu_torch.kernels.histogram import masked_histogram_counts
    from piccolo_tpu_torch.main import main as cli_main

    base = os.path.dirname(omni["tree"])
    traces = os.path.join(base, "omni_traces")
    log_dir = os.path.join(base, "log_omni_tracking_profiled")
    wrappers = {"slab_group_sums_f32": slab.slab_group_sums_f32,
                "block_histogram": block_histogram,
                "masked_histogram_counts": masked_histogram_counts}
    for fn in wrappers.values():
        fn.launches = 0
    before = solver.graph_stats()
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            cli_main(["--config", OMNI_CONFIG, "--log", log_dir,
                      "--no-tensorboard", "--device", dev.type, "--override",
                      f"data_root={omni['tree']},tracking=True,"
                      f"sharpen_color=True,profile_dir={traces}"])
    except Exception:
        print(buf.getvalue()[-6000:], flush=True)
        raise
    wall = time.time() - t0
    after = solver.graph_stats()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    modes = [ln.split(":", 1)[1].strip() for ln in buf.getvalue().splitlines()
             if ln.startswith("tracking :")]
    rows = _omni_csv(log_dir)
    ref = _omni_csv(os.path.join(base, "log_omni_tracking_sharpen_color"))
    names = sorted(glob.glob(os.path.join(traces, "*.pt.trace.json")))
    counts = [_trace_counts(p) for p in names]
    in_traces = {k: sum(c["own"][k] for c in counts) for k in wrappers}
    log(f"omniscenes cli profile_dir (tracking, sharpen_color): modes "
        f"{modes}; {len(names)} traces, "
        f"{sum(os.path.getsize(p) for p in names)} B, wall {wall:.2f} s; "
        f"captures {after['captures'] - before['captures']}, recaptures "
        f"{after['recaptures'] - before['recaptures']}; wrapper launches "
        f"{launches}; in the traces {in_traces}")
    log("omniscenes profile_dir: " + json.dumps(
        [dict(trace=os.path.basename(p), **c) for p, c in zip(names, counts)]))
    if modes != ["seed"] + ["tracked"] * (OMNI_QUERIES - 1):
        raise AssertionError(f"omniscenes profiled run: modes {modes}")
    if len(names) != OMNI_QUERIES:
        raise AssertionError(f"{len(names)} traces for {OMNI_QUERIES} frames")
    if [r_[:8] for r_ in rows] != [r_[:8] for r_ in ref]:
        raise AssertionError("the profiled OmniScenes run's rows differ "
                             f"from phase 19's: {rows} against {ref}")
    if (after["captures"], after["recaptures"]) != (before["captures"],
                                                    before["recaptures"]):
        raise AssertionError("the profiled OmniScenes run captured or "
                             f"recaptured a graph: {before} -> {after}")
    if in_traces != launches or not launches["masked_histogram_counts"]:
        raise AssertionError(f"kernels in the traces {in_traces}, launched "
                             f"{launches}")
    return counts


def phase_omni_track_profile(o, dev, median_s):
    """One tracked frame (the device colour prep and the 30-iteration
    descent from the fused winner) under torch.profiler."""
    from piccolo_tpu_torch.color import cloud_color_cdf
    from piccolo_tpu_torch.convert import cdf_from_numpy
    from piccolo_tpu_torch.data import obtain_gt_omniscenes
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.harness.localize import resize_ablate_omniscenes
    from piccolo_tpu_torch.tracking import (
        track_kwargs,
        track_step_prepped_fetched,
        ypr_from_rot,
    )

    room = o["room"]
    img_u8 = resize_ablate_omniscenes(o["cfg"], imread_rgb(o["gt"]))
    cdf = cdf_from_numpy(cloud_color_cdf(room["rgb_np"]), dev)
    gt_t, gt_r = obtain_gt_omniscenes(o["gt"])
    t0 = np.asarray(gt_t, np.float32).reshape(3) + np.float32([0.03, -0.02, 0])
    y0 = ypr_from_rot(np.asarray(gt_r).reshape(3, 3))

    def run():
        return track_step_prepped_fetched(
            img_u8, room["xyz"], room["rgb"], t0, y0, room["lo"], room["hi"],
            room["mask"], cdf=cdf, device=dev, **track_kwargs(o["cfg"]))

    t, _, _, _ = run()  # warm-up
    log(f"tracked frame from 3 cm off: t_err "
        f"{np.linalg.norm(t - np.ravel(gt_t)):.4f} m")
    profile_query("tracked frame", run, median_s)


def phase_serving(dev, tmp, cli_tree):
    """configs/stanford.ini served by LocalizeService on the CLI room
    (60,000 points, 1024x512), warmed at load, behind serve_forever on
    loopback: /healthz, 10 /localize requests by image_path and one by
    image_b64, each bit-equal to _run_fused on the same room and image
    (p50 and p90 of total_s); a tracked request chained through prev_pose;
    a recover_above request that recovers; one request under
    torch.profiler.  Then room = "auto" under the shipped config over the
    CLI room and a second ray-cast office (ROOM_AUTO_TREE), by a full query
    per room and with room_auto_probe = "batched" (the per-room probe):
    each query's room scores must rank the rooms as ROOM_AUTO_RECORD says;
    and one easy case, the CLI room repainted (colours inverted), whose
    repainted query must pick it.  Returns the served requests' total_s and
    launches."""
    import base64
    import urllib.request

    from piccolo_tpu_torch.config import apply_overrides, parse_ini
    from piccolo_tpu_torch.data import obtain_gt_stanford, read_stanford
    from piccolo_tpu_torch.harness.imaging import imread_rgb, imwrite_rgb
    from piccolo_tpu_torch.harness.localize import _run_fused
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import block_histogram
    from piccolo_tpu_torch.kernels.splat_hist import splat_block_counts
    from piccolo_tpu_torch.serve import LocalizeService, serve_forever
    from piccolo_tpu_torch.testing import write_synth_stanford
    from piccolo_tpu_torch.tracking import ypr_from_rot

    panos = sorted(glob.glob(os.path.join(cli_tree, "stanford", "pano",
                                          "area_1", "*.png")))
    pcd = os.path.join(cli_tree, "stanford", "pcd_not_aligned", "area_1",
                       "office_1.txt")
    # the second room: ROOM_AUTO_TREE's office_2; its office_1 and first
    # panorama are the CLI room and its first query, file for file
    auto_tree = os.path.join(tmp, "auto")
    write_synth_stanford(auto_tree, **ROOM_AUTO_TREE)
    auto_pcds = sorted(glob.glob(os.path.join(
        auto_tree, "stanford", "pcd_not_aligned", "area_1", "*.txt")))
    auto_panos = sorted(glob.glob(os.path.join(
        auto_tree, "stanford", "pano", "area_1", "*.png")))
    for a, b in ((auto_pcds[0], pcd), (auto_panos[0], panos[0])):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{a} differs from the CLI tree's {b}")
    pcd2 = auto_pcds[1]
    # the easy case: the CLI room and its first query repainted
    xyz, rgb = read_stanford(pcd, 1)
    pcd_inv = os.path.join(tmp, "office_1_repainted.txt")
    np.savetxt(pcd_inv, np.concatenate([xyz, 255.0 - rgb * 255.0], 1),
               fmt="%.6f")
    pano_inv = os.path.join(tmp, "query_repainted.png")
    imwrite_rgb(pano_inv, 255 - imread_rgb(panos[0]))
    cfg = parse_ini(CONFIG)
    kernels = {fn.__name__: fn for fn in (
        slab.slab_group_sums_f32, slab.slab_group_sums_compact,
        slab.slab_group_sums_q8, block_histogram, splat_block_counts)}
    svc = LocalizeService(cfg, max_rooms=2, device=dev)
    t0 = time.time()
    svc.load_room(xyz.astype(np.float32), rgb.astype(np.float32), name=pcd,
                  warm_shape=(512, 1024))
    log(f"serving: room {pcd} loaded and warmed at 1024x512 in "
        f"{time.time() - t0:.2f} s")
    cache = svc._rooms[pcd][0]
    want = {}
    for p in panos:
        img = imread_rgb(p)
        ii, im, ru, _ = svc._prepare(img, cache)
        res, _ = _run_fused(ii, im, cache, ru, svc.cfg, svc.init_dict,
                            cache["grids"], sync_plans=True)
        want[p] = (res.t.cpu().numpy(), float(res.loss))

    ready = threading.Event()
    th = threading.Thread(target=serve_forever, args=(svc, "127.0.0.1", 0,
                                                      ready), daemon=True)
    th.start()
    if not ready.wait(30):
        raise AssertionError("the server did not start")
    server = ready.server
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(f"{base}{path}",
                                     data=json.dumps(payload).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    def check(p, out):
        t, loss = want[p]
        if not (np.array_equal(np.float32(out["t"]), t)
                and out["loss"] == loss):
            raise AssertionError(f"served answer for {p} differs from "
                                 f"_run_fused: {out['t']} vs {t}")

    def check_auto(mode, p, out):
        """Query ``p``'s room and room scores are as recorded."""
        scores = out["room_scores"]
        got = (os.path.basename(out["room"]), [
            os.path.basename(k) for k in sorted(
                scores,
                key=lambda k: math.inf if scores[k] is None else scores[k])])
        query = os.path.basename(p).split("_")[1]
        if got != ROOM_AUTO_RECORD[mode][query]:
            raise AssertionError(
                f"room=auto (room_auto_probe={mode}) picked {got[0]} and "
                f"ranked {got[1]} for query {query}, recorded "
                f"{ROOM_AUTO_RECORD[mode][query]}: {scores}")
        return got

    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if not (health["ok"] and health["rooms"] == [pcd]):
            raise AssertionError(f"healthz {health}")
        for fn in kernels.values():
            fn.launches = 0
        totals = []
        for i in range(SERVED_REQUESTS):
            p = panos[i % len(panos)]
            out = post("/localize", {"image_path": p})
            check(p, out)
            totals.append(out["total_s"])
        launches = {k: fn.launches for k, fn in kernels.items()}
        with open(panos[1], "rb") as f:
            out = post("/localize", {"image_b64": base64.b64encode(
                f.read()).decode()})
        check(panos[1], out)
        p50, p90 = (float(np.percentile(totals, q)) for q in (50, 90))
        log(f"serving: {SERVED_REQUESTS} requests by image_path and 1 by "
            f"image_b64, each bit-equal to _run_fused; total_s p50 {p50:.4f} "
            f"p90 {p90:.4f} (all {[round(v, 4) for v in totals]}); launches "
            f"over the {SERVED_REQUESTS} {launches}")

        first = post("/localize", {"image_path": panos[0]})
        prev = {"t": first["t"],
                "ypr": ypr_from_rot(np.array(first["rot"])).tolist()}
        chain = []
        for _ in range(2):
            out = post("/localize", {"image_path": panos[0],
                                     "prev_pose": prev})
            if not out.get("tracked") or out.get("recovered"):
                raise AssertionError(f"tracked request not tracked: {out}")
            prev = {"t": out["t"], "ypr": out["ypr"]}
            chain.append(out)
        gt_t, _ = obtain_gt_stanford(cli_tree, 1, os.path.basename(panos[0]))
        dt = float(np.linalg.norm(np.float32(chain[-1]["t"]) - np.ravel(gt_t)))
        if not dt < 0.05:
            raise AssertionError(f"the tracked requests end {dt} m from the "
                                 "truth")
        # from pano 0's pose, 30 tracked iterations cannot reach pano 1's
        # optimum: a loss over 1.1x the full answer's means tracking is lost
        rec = post("/localize", {"image_path": panos[1], "prev_pose": prev,
                                 "recover_above": want[panos[1]][1] * 1.1})
        if not rec.get("recovered"):
            raise AssertionError(f"recover_above did not recover: {rec}")
        check(panos[1], rec)
        log(f"serving: 2 tracked requests chained through prev_pose "
            f"(total_s {[round(o_['total_s'], 4) for o_ in chain]}, t_err "
            f"{dt:.4f} m); a recover_above request "
            f"recovered to the full answer (total_s {rec['total_s']:.4f})")
        img0 = imread_rgb(panos[0])
        profile_query("served request", lambda: svc.localize(img0), p50)

        # room = "auto", a full query per room: the second room's query
        # first, so that the CLI room is the most recently used after
        room2 = post("/room", {"pcd_path": pcd2})
        if room2["room"] != pcd2 or svc.rooms != [pcd, pcd2]:
            raise AssertionError(f"/room: {room2}, {svc.rooms}")
        for p in (auto_panos[1], panos[0]):
            out = post("/localize", {"image_path": p, "room": "auto"})
            picked, order = check_auto("False", p, out)
            log(f"serving: room=auto, a full query per room: "
                f"{os.path.basename(p).split('_')[1]} picked {picked}, "
                f"ranked {order} as recorded (scores {out['room_scores']}, total_s "
                f"{out['total_s']:.4f})")
        # the easy case: the repainted room evicts the second one
        post("/room", {"pcd_path": pcd_inv})
        out = post("/localize", {"image_path": pano_inv, "room": "auto"})
        if out["room"] != pcd_inv:
            raise AssertionError(f"room=auto chose {out['room']} for the "
                                 f"repainted query: {out['room_scores']}")
        log(f"serving: room=auto chose the repainted room for the repainted "
            f"query (scores {out['room_scores']}, total_s "
            f"{out['total_s']:.4f})")
    finally:
        server.shutdown()
        server.server_close()
    del svc

    # room_auto_probe = "batched": the per-room probe, then the full
    # queries of the rooms within the margin
    auto = LocalizeService(apply_overrides(cfg, "room_auto_probe=batched"),
                           max_rooms=2, device=dev)
    for name in (pcd, pcd2):
        x, c = read_stanford(name, 1)
        auto.load_room(x.astype(np.float32), c.astype(np.float32), name=name)
    probes = []
    real = auto._probe_room
    auto._probe_room = lambda *a: probes.append(a[1]) or real(*a)
    for p in (auto_panos[1], panos[0]):
        n = len(probes)
        out = auto.localize(imread_rgb(p), room="auto")
        picked, order = check_auto("True", p, out)
        if len(probes) - n != 2:
            raise AssertionError(f"{len(probes) - n} probes for 2 rooms")
        log(f"serving: room=auto, room_auto_probe=batched (per-room probe): "
            f"{os.path.basename(p).split('_')[1]} picked {picked}, ranked "
            f"{order} as recorded (scores {out['room_scores']}, total_s {out['total_s']:.4f})")
    del auto
    session = _serving_session(cfg, pcd, pcd2, panos, auto_panos, dev,
                               check_auto)
    torch.cuda.empty_cache()
    return dict(p50=p50, p90=p90, launches=launches, totals=totals,
                session=session)


def _graphs_touched(before, after):
    """The capture numbers of the graphs captured or replayed between two
    solver.graph_stats() snapshots."""
    old = {g["capture"]: g["replays"] for g in before["graphs"]}
    return {g["capture"] for g in after["graphs"]
            if g["replays"] > old.get(g["capture"], -1)}


def _serving_session(cfg, pcd, pcd2, panos, auto_panos, dev, check_auto):
    """Phase 22, with sharpen_color = False, on two services that each hold
    both offices: one with room_auto_probe = "batched" and track_batch =
    True (track_max_batch 4), one with the per-room probe
    (room_auto_probe = True).  (a) Both queries with room = "auto", the two
    services in turns, 6 rounds (round 0 captures; p50 of total_s over
    rounds 1-5 of each); the batched service must pick and rank as
    ROOM_AUTO_RECORD["batched"] without a per-room probe, the per-room one
    as ROOM_AUTO_RECORD["True, sharpen_color=False"] with two.  (b) The
    probes alone on one query, median of 5 each: the batched probe, its
    loss tables, and the per-room probe of both rooms; one profile of each
    probe.  (c) track_batch on the batched
    service in each room (_serving_track_batch).  Every graph key the
    batched service used in (a)-(c) is counted, with its pool and static
    bytes; the session must recapture nothing."""
    from piccolo_tpu_torch import solver
    from piccolo_tpu_torch.config import apply_overrides
    from piccolo_tpu_torch.data import read_stanford
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.serve import LocalizeService

    svcs = {}
    for mode, extra in (("batched", ",track_batch=True,track_max_batch=4"),
                        ("True", "")):
        svcs[mode] = LocalizeService(apply_overrides(
            cfg, f"room_auto_probe={mode},sharpen_color=False{extra}"),
            max_rooms=2, device=dev)
        for name in (pcd, pcd2):
            x, c = read_stanford(name, 1)
            svcs[mode].load_room(x.astype(np.float32), c.astype(np.float32),
                                 name=name, warm_shape=(512, 1024))
    svc = svcs["batched"]
    touched, lock = set(), threading.Lock()
    real_localize = svc.localize

    def localize(*a, **kw):
        before = solver.graph_stats()
        out = real_localize(*a, **kw)
        with lock:
            touched.update(_graphs_touched(before, solver.graph_stats()))
        return out

    svc.localize = localize
    counts0 = solver.graph_stats()
    batched, per_room = [], {m: [] for m in svcs}
    real_b = svc._probe_state_batched
    svc._probe_state_batched = lambda i: batched.append(i) or real_b(i)
    for m, sv in svcs.items():
        real_p = sv._probe_room
        sv._probe_room = (lambda real_p, m: lambda *a: per_room[m].append(
            a[1]) or real_p(*a))(real_p, m)
    records = {"batched": "batched", "True": "True, sharpen_color=False"}
    totals = {m: [] for m in svcs}
    queries = [(p, imread_rgb(p)) for p in (auto_panos[1], panos[0])]
    for rnd in range(6):
        for qi, (p, img) in enumerate(queries):
            order = list(svcs) if (rnd + qi) % 2 == 0 else list(svcs)[::-1]
            for m in order:
                out = svcs[m].localize(img, room="auto")
                picked, ranked = check_auto(records[m], p, out)
                if rnd:
                    totals[m].append(out["total_s"])
                if rnd in (0, 5):
                    log(f"serving: room=auto, room_auto_probe={m}, "
                        f"sharpen_color=False, round {rnd}: "
                        f"{os.path.basename(p).split('_')[1]} picked "
                        f"{picked}, ranked {ranked} as recorded (scores "
                        f"{out['room_scores']}, total_s "
                        f"{out['total_s']:.4f})")
    if per_room["batched"] or len(batched) != 12:
        raise AssertionError(f"batched probe: {len(batched)} batched probes, "
                             f"{len(per_room['batched'])} per-room probes "
                             "for 12 requests")
    if len(per_room["True"]) != 24:
        raise AssertionError(f"per-room probe: {len(per_room['True'])} "
                             "probes for 12 requests over 2 rooms")
    p50 = {m: float(np.median(v)) for m, v in totals.items()}
    log(f"serving: room=auto, sharpen_color=False, the same 2 queries in "
        f"turns, 5 warm rounds: total_s p50 one-program probe "
        f"{p50['batched']:.4f} s, per-room probe {p50['True']:.4f} s "
        f"(x{p50['True'] / p50['batched']:.2f}); all batched "
        f"{[round(v, 4) for v in totals['batched']]}, per-room "
        f"{[round(v, 4) for v in totals['True']]}")
    # the probes alone on the second query: the batched probe, its loss
    # tables (score_pose_grid per room, the part before its descent), and
    # the per-room probe of both rooms (prep done first), median of 5 each
    from piccolo_tpu_torch.init.refine import score_pose_grid

    st = real_b(0)
    img_init = svc._prepare(queries[1][1], svc._rooms[pcd][0])[0]
    kw = svc._probe_kwargs()
    img_d = torch.as_tensor(img_init, dtype=torch.float32, device=dev)
    per = svcs["True"]
    preps = [(per._prep_head(queries[1][1], per._rooms[n][0]),
              per._rooms[n][0]) for n in (pcd, pcd2)]
    for prep, cache in preps:
        per._finish(prep, cache)

    def tables():
        for r in range(len(st.names)):
            score_pose_grid(img_d, st.xyz[r], st.rgb[r], st.trans[r], st.rot,
                            st.point_mask[r], valid=st.trans_valid[r],
                            wrap=kw["wrap"])

    def per_room_probes():
        for prep, cache in preps:
            per._probe_room(prep, cache, 0)

    runs = {"batched probe": lambda: st.losses(img_init, **kw),
            "its loss tables": tables, "per-room probe": per_room_probes}
    med = {}
    for name, fn in runs.items():
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        med[name] = float(np.median(walls))
    probe_s = med["batched probe"]
    log(f"serving: the probes alone over {len(st.names)} rooms, median of 5: "
        f"batched {probe_s:.4f} s ({tuple(st.trans.shape)} probe grids x "
        f"{tuple(st.rot.shape)} rotations, {kw['num_starts']} starts x "
        f"{kw['num_iter']} iterations a room), of it the loss tables "
        f"{med['its loss tables']:.4f} s; per-room probes of both rooms "
        f"{med['per-room probe']:.4f} s")
    for name in ("batched probe", "per-room probe"):
        profile_query(f"{name}, 2 rooms", runs[name], med[name])
    del svcs["True"], per, preps
    tracks = {os.path.basename(room): _serving_track_batch(svc, room, p)
              for room, p in ((pcd, panos[0]), (pcd2, auto_panos[1]))}
    counts1 = solver.graph_stats()
    keys = [g for g in counts1["graphs"] if g["capture"] in touched]
    if len(keys) != len(touched):
        raise AssertionError(f"{len(touched) - len(keys)} graphs the "
                             "session used were evicted")
    moved = {k: counts1[k] - counts0[k]
             for k in ("captures", "evictions", "recaptures")}
    pool = sum(g["pool_bytes"] for g in keys)
    static = sum(g["static_bytes"] for g in keys)
    cap = solver.GRAPH_MEM_FRACTION * torch.cuda.get_device_properties(
        dev).total_memory
    log(f"serving: the two-room session with the batched probe and "
        f"track_batch used {len(keys)} graph keys (starts, cloud rows, "
        f"table rows: {[(g['starts'], g['cloud'], g['table']) for g in keys]}"
        f"), pools {pool / 2**20:.1f} MiB and static buffers "
        f"{static / 2**20:.1f} MiB, {(pool + static) / cap:.3f} of the "
        f"graphs' cap ({cap / 2**30:.2f} GiB); in the phase {moved}")
    if moved["recaptures"]:
        raise AssertionError(f"the serving session recaptured: {moved}")
    del svc, st
    return dict(probe_s=med, total_s_p50=p50, track_batch=tracks,
                keys=len(keys), graph_bytes=pool + static)


def _serving_track_batch(svc, room, pano):
    """track_batch on ``svc`` (sharpen_color = False, so the requests share
    the room's colours): four tracked requests in ``room`` from four warm
    starts near ``pano``'s answer, first one at a time (no batch), then
    released together from four threads, up to 5 rounds until a drained
    batch (``"batched"`` > 1) is seen.  Each batched answer must lie
    within BATCH_BOUND of its own single request, each unbatched one
    equal it."""
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.tracking import ypr_from_rot

    img0 = imread_rgb(pano)
    first = svc.localize(img0, room=room)
    t = np.float32(first["t"])
    y = ypr_from_rot(np.asarray(first["rot"]))
    steps = np.float32([[0.03, -0.02, 0.0], [-0.02, 0.03, 0.01],
                        [0.02, 0.02, -0.01], [-0.03, -0.01, 0.0]])
    prevs = [{"t": (t + d).tolist(), "ypr": y.tolist()} for d in steps]
    singles = [svc.localize(img0, room=room, prev_pose=p_) for p_ in prevs]
    if any("batched" in o for o in singles):
        raise AssertionError("a serial tracked request was batched")
    rounds = []
    for _ in range(5):
        outs = [None] * 4
        gate = threading.Barrier(4)

        def go(i):
            gate.wait()
            outs[i] = svc.localize(img0, room=room, prev_pose=prevs[i])

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        if any(o is None for o in outs):
            raise AssertionError("a concurrent tracked request failed")
        for o, one in zip(outs, singles):
            d = max(float(np.abs(np.float32(o["t"]) - one["t"]).max()),
                    float(np.abs(np.float32(o["ypr"]) - one["ypr"]).max()))
            if not (d <= BATCH_BOUND if "batched" in o else d == 0.0):
                raise AssertionError(f"tracked answer {d} from its single "
                                     f"request (batched {o.get('batched')})")
        rounds.append(([o.get("batched", 1) for o in outs],
                       [round(o["total_s"], 4) for o in outs]))
        if max(rounds[-1][0]) > 1:
            break
    log(f"serving: track_batch in {os.path.basename(room)}, 4 concurrent "
        f"tracked requests a round: (batch sizes, total_s) per round "
        f"{rounds}; single requests' total_s "
        f"{[round(o['total_s'], 4) for o in singles]}")
    if max(rounds[-1][0]) <= 1:
        raise AssertionError("no drained batch with K > 1 in 5 rounds")
    return rounds


def note_graphs():
    """Merge the descent graphs cached now into GRAPHS (the LRU may evict a
    graph before the end of the run); every pool must have been counted."""
    from piccolo_tpu_torch import solver

    for g in solver.graph_stats()["graphs"]:
        if not g["pool_bytes"] > 0:
            raise AssertionError(f"graph {g} reports no pool")
        GRAPHS[g["capture"]] = g


def _percentiles(xs):
    return tuple(float(np.percentile(xs, q)) for q in (50, 90))


def _same_descent(got, want):
    """Whether two descend_starts results are bit-equal: final poses,
    losses, learning rates and any trajectory."""
    pairs = list(zip(got[0].leaves(), want[0].leaves()))
    pairs += [(got[1], want[1]), (got[2], want[2])]
    if got[3] is not None:
        pairs += list(zip(got[3].leaves(), want[3].leaves()))
    return all(torch.equal(a, b) for a, b in pairs)


def phase_graph_vs_eager(room, dev):
    """The descent's captured graph against the eager loop on the library
    room.  (a) From one query's six starts, descend_starts graphed and
    eager (_eager=True) for the default 6 x 100 descent, prune (30, 2),
    multires (70, 2) and trajectory: final poses, losses and learning rates
    (and every trajectory step) bit-equal.  (b) 10 queries each way, in
    turns, through localize_query: the same winners and candidate losses
    bit for bit, and s/query p50 and p90 of each."""
    from piccolo_tpu_torch.solver import descend_starts

    r = room
    _, _, img_init, img_main = _query_images(300, r["xyz"], r["rgb"], dev)
    res = _query(r, img_init, img_main, dev)
    lo, hi = (torch.as_tensor(b, device=dev) for b in (r["lo"], r["hi"]))
    modes = {"default 6 x 100": {}, "prune (30, 2)": dict(prune=(30, 2)),
             "multires (70, 2)": dict(multires=(70, 2)),
             "trajectory": dict(trajectory=True)}
    def run(n, eager=False, **kw):
        return descend_starts(
            img_main, r["xyz_d"], r["rgb_d"], res.start_t, res.start_ypr, lo,
            hi, r["mask_d"], n, 0.1, 5, 0.8, "float32", False,
            table_arg="auto", _eager=eager, **kw)

    graphed = {}
    for name, kw in modes.items():
        outs = [run(100, eager, **kw) for eager in (False, True)]
        if not _same_descent(*outs):
            raise AssertionError(f"graph and eager descents differ: {name}")
        graphed[name] = outs[0]
        log(f"graph vs eager, library room, {name}: final poses, losses and "
            f"lrs bit-equal" + (", every trajectory step too"
                                if kw.get("trajectory") else ""))
    # prune's survivors against the same starts' unpruned descent: the
    # second phase's batch of 2 may add its reductions in another order
    head = run(30)
    keep = torch.argsort(head[1], stable=True)[:2]
    pruned, full = graphed["prune (30, 2)"][0], graphed["default 6 x 100"][0]
    d = max(float((pruned.t[keep] - full.t[keep]).abs().max()),
            float((pruned.ypr()[keep] - full.ypr()[keep]).abs().max()))
    log(f"prune (30, 2) on the card: survivors {keep.tolist()} within {d:.3g} "
        f"(m or rad) of their unpruned descent (bound {PRUNE_BOUND})")
    if not d <= PRUNE_BOUND:
        raise AssertionError(f"pruned survivors {d} from their unpruned "
                             "descent")

    def one(seed, eager):
        _, _, ii, im = _query_images(seed, r["xyz"], r["rgb"], dev)
        torch.cuda.synchronize()
        t0 = time.time()
        q = _query(r, ii, im, dev, _eager=eager)
        q.t.cpu()
        return time.time() - t0, q

    one(399, True)
    secs = {False: [], True: []}
    for i in range(10):
        pair = {}
        for eager in ((False, True) if i % 2 == 0 else (True, False)):
            sec, pair[eager] = one(400 + i, eager)
            secs[eager].append(sec)
        a, b = pair[False], pair[True]
        if not (torch.equal(a.cand_t, b.cand_t)
                and torch.equal(a.cand_loss, b.cand_loss)
                and int(a.winner) == int(b.winner)):
            raise AssertionError(f"query {400 + i}: graphed and eager "
                                 "queries differ")
    (g50, g90), (e50, e90) = _percentiles(secs[False]), _percentiles(secs[True])
    log(f"graph vs eager, library queries: 10 each, in turns, same winners "
        f"and candidate losses bit for bit; graphed s/query p50 {g50:.4f} "
        f"p90 {g90:.4f}, eager p50 {e50:.4f} p90 {e90:.4f} (x{e50 / g50:.2f})"
        f"; all graphed {[round(v, 4) for v in secs[False]]}, eager "
        f"{[round(v, 4) for v in secs[True]]}")
    return dict(graphed=(g50, g90), eager=(e50, e90))


def _descent_query_counts(room, dev):
    """One library query (phase 20's room, its graphs captured already)
    under torch.profiler, the step's launch count zeroed just before: the
    pair's kernels in its trace, its descent graphs' replays
    (solver.graph_stats) and the wrapper's eager launches and captures.
    The trace must hold each kernel once a replay or launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from piccolo_tpu_torch import solver
    from piccolo_tpu_torch.kernels.descent_step import descent_step

    _, _, img_init, img_main = _query_images(301, room["xyz"], room["rgb"],
                                             dev)
    _query(room, img_init, img_main, dev)  # this image's first call
    torch.cuda.synchronize()
    descent_step.launches = 0
    before = solver.graph_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _query(room, img_init, img_main, dev)
        torch.cuda.synchronize()
    after = solver.graph_stats()
    old = {g["capture"]: g["replays"] for g in before["graphs"]}
    replays = sum(g["replays"] - old.get(g["capture"], 0)
                  for g in after["graphs"])
    traced = {"descent_partials_kernel": 0, "descent_update_kernel": 0}
    n_device = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        n_device += 1
        for k in traced:
            traced[k] += k in e.name()
    out = dict(replays=replays, launches=descent_step.launches,
               traced=traced if n_device else None,
               captures=after["captures"] - before["captures"])
    log(f"descent step in one library query: {replays} graph replays, "
        f"{out['launches']} eager launches or captures of the pair, "
        f"{out['captures']} captures; in its trace "
        + ("no device time (not measured)" if not n_device else
           ", ".join(f"{k} {v}" for k, v in traced.items())))
    if n_device and set(traced.values()) != {replays + out["launches"]}:
        raise AssertionError(f"descent step: the trace holds {traced}, the "
                             f"graphs replayed {replays} times and the "
                             f"wrapper launched {out['launches']} times")
    if not replays:
        raise AssertionError("descent step: the library query replayed no "
                             "descent graph")
    return out


def phase_descent_step(room, dev):
    """Phase 41: the pair's launches in one library query
    (_descent_query_counts), then scripts/bench_descent_step.py's checks
    and timings of the descent step's kernels at the OmniScenes cell's
    shapes; returns a kernels-line row for each timed shape."""
    from scripts import bench_descent_step

    counts = _descent_query_counts(room, dev)
    out = bench_descent_step.measure(log=log)
    if not out["ok"]:
        raise AssertionError("descent step: the kernels' checks failed (see "
                             "the lines above)")
    rows = []
    for t in out["timing"]:
        row = dict(
            name="descent_step", route="the captured step on one cloud",
            source="piccolo_tpu_torch/kernels/csrc/descent_step.cu",
            replaces="none: added (the JAX descent is an XLA gather)",
            ms=t["kernel_graph_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
            max_abs_err=None, autograd_graph_ms=t["autograd_graph_ms"])
        timed_at = (f"timed at the OmniScenes cell's shapes, "
                    f"{t['starts']} {'stacked streams' if t['stacked'] else 'starts'}"
                    f" x {t['points']} points, 2048x1024 bf16 table")
        if t["stacked"]:  # tracked batches: timed, their launches not counted
            row.update(path=f"{timed_at}; launches not counted",
                       launches=None, launches_per_query=None,
                       replays_per_query=None)
        else:
            n = (None if counts["traced"] is None
                 else counts["traced"]["descent_partials_kernel"])
            row.update(path=f"{timed_at}; launches: one library query's "
                            "trace (graph replays included)",
                       launches=n, launches_per_query=n,
                       replays_per_query=counts["replays"])
        rows.append(row)
    return rows


def phase_cli_parallel(cli_tree, dev):
    """The shipped configs/stanford_parallel.ini (4 x 4 x 4 rotations, pitch
    and roll in every start, sample_rate 6) through the CLI and its ladder
    on the CLI's tree: route, accuracy, t_err and s/query."""
    from piccolo_tpu_torch.main import main as cli_main

    log_dir = os.path.join(os.path.dirname(cli_tree), "log_parallel")
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            acc = cli_main(["--config", PARALLEL_CONFIG, "--log", log_dir,
                            "--no-tensorboard", "--device", dev.type,
                            "--override", f"data_root={cli_tree}"])
    except Exception:
        print(buf.getvalue()[-6000:], flush=True)
        raise
    wall = time.time() - t0
    routes = [ln.split(":", 1)[1].strip() for ln in buf.getvalue().splitlines()
              if ln.startswith("route :")]
    rows = _csv_rows(log_dir)
    t_err = [float(r_[7]) for r_ in rows]
    r_err = [float(r_[8]) for r_ in rows]
    q_s = float(np.median([float(r_[9]) for r_ in rows]))
    log(f"cli stanford_parallel.ini: routes {routes}; accuracy {acc}; t_err "
        f"(m) {[round(v, 4) for v in t_err]}; r_err (deg) "
        f"{[round(v, 3) for v in r_err]}; median time (s) {q_s:.4f}; wall "
        f"{wall:.2f} s")
    if len(rows) != CLI_QUERIES or not np.isfinite(t_err).all():
        raise AssertionError(f"stanford_parallel.ini: {len(rows)} rows, "
                             f"t_err {t_err}")
    if not acc >= PARALLEL_MIN_ACCURACY:
        raise AssertionError(f"stanford_parallel.ini: accuracy {acc}")
    return dict(acc=acc, s=q_s, routes=routes)


def phase_omni_batch(o, omni, dev):
    """On the OmniScenes room, with each frame's colour prep (match_color)
    done first: one tracked frame's descent graphed against eager
    (bit-equal); then track_steps_batched over K = 1, 2 and 4 of the video's
    frames from 3 cm off their poses, each stream against its own
    track_step (K = 1 bit-equal; K > 1 within BATCH_BOUND, the batch's
    backward adds a stream's terms in another order), and each batch's wall
    and device ms against K single steps."""
    from piccolo_tpu_torch import tracking as T
    from piccolo_tpu_torch.color import cloud_color_cdf
    from piccolo_tpu_torch.convert import cdf_from_numpy
    from piccolo_tpu_torch.data import obtain_gt_omniscenes, omniscenes_pano_glob
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.harness.localize import resize_ablate_omniscenes
    from piccolo_tpu_torch.solver import descend

    room, cfg = o["room"], o["cfg"]
    kw = T.track_kwargs(cfg)
    cdf = cdf_from_numpy(cloud_color_cdf(room["rgb_np"]), dev)
    imgs, ts, ys = [], [], []
    for p in sorted(glob.glob(omniscenes_pano_glob(omni["tree"]))):
        u8 = resize_ablate_omniscenes(cfg, imread_rgb(p))
        img, _ = T.colour_frame(T.upload_frame(u8, dev), cdf, None,
                                room["rgb"])
        imgs.append(img)
        gt_t, gt_r = obtain_gt_omniscenes(p)
        ts.append(np.asarray(gt_t, np.float32).reshape(3)
                  + np.float32([0.03, -0.02, 0.0]))
        ys.append(T.ypr_from_rot(np.asarray(gt_r).reshape(3, 3)))
    imgs, ts, ys = torch.stack(imgs), np.stack(ts), np.stack(ys)
    box = (room["lo"], room["hi"], room["mask"])

    outs = [descend(imgs[0], room["xyz"], room["rgb"], ts[:1], ys[:1], *box,
                    masked=True, device=dev, _eager=eager, **kw)
            for eager in (False, True)]
    a, b = outs
    if not all(torch.equal(x, y) for x, y in ((a.t, b.t), (a.ypr, b.ypr),
                                              (a.loss, b.loss), (a.lr, b.lr))):
        raise AssertionError("tracked frame: graphed and eager descents differ")
    log("graph vs eager, tracked OmniScenes frame (2048x1024, bf16 table, "
        "1 start x 30): final pose, loss and lr bit-equal")

    def single(k):
        return T.track_step_fetched(imgs[k], room["xyz"], room["rgb"], ts[k],
                                    ys[k], *box, device=dev, **kw)

    def batch(K):
        return T.track_steps_batched(imgs[:K], room["xyz"], room["rgb"],
                                     ts[:K], ys[:K], *box, device=dev, **kw)

    out = {}
    for K in (1, 2, 4):
        got = batch(K)
        worst = 0.0
        for k in range(K):
            want = single(k)
            if K == 1:
                if not all(np.array_equal(x, y) for x, y in zip(got[k][:3],
                                                                want[:3])):
                    raise AssertionError("K = 1 differs from track_step")
            d = max(float(np.abs(got[k][0] - want[0]).max()),
                    float(np.abs(got[k][1] - want[1]).max()))
            worst = max(worst, d)
            if not d <= BATCH_BOUND:
                raise AssertionError(f"K = {K}, stream {k}: {d} from its "
                                     "own track_step")
        walls_b, walls_s = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch(K)
            walls_b.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for k in range(K):
                single(k)
            walls_s.append(time.perf_counter() - t0)
        dev_b = cuda_ms(lambda: batch(K), reps=5, lead=BATCH_LEAD_CYCLES)
        dev_s = cuda_ms(lambda: [single(k) for k in range(K)], reps=5,
                        lead=BATCH_LEAD_CYCLES)
        out[K] = dict(wall_batch=float(np.median(walls_b)),
                      wall_single=float(np.median(walls_s)),
                      device_batch=dev_b, device_single=dev_s, worst=worst)
        log(f"track_steps_batched K = {K}: streams within {worst:.3g} of their "
            f"own track_step (m or rad); wall {out[K]['wall_batch'] * 1e3:.2f} "
            f"ms against {K} single steps' {out[K]['wall_single'] * 1e3:.2f} "
            f"ms; device {dev_b:.2f} ms against {dev_s:.2f} ms")
    # the witness that the K > 1 gap is the order of the batch's reductions
    # alone: each stream of the K = 4 batch ends bit for bit where it ends
    # in a K = 4 batch of four copies of itself, and the copies agree
    got4 = batch(4)
    for k in range(4):
        copies = T.track_steps_batched(
            imgs[k:k + 1].repeat(4, 1, 1, 1), room["xyz"], room["rgb"],
            np.repeat(ts[k:k + 1], 4, 0), np.repeat(ys[k:k + 1], 4, 0), *box,
            device=dev, **kw)
        if not all(np.array_equal(c[i], got4[k][i]) for c in copies
                   for i in range(3)):
            raise AssertionError(f"stream {k} of a K = 4 batch differs from "
                                 "a batch of four copies of itself")
    gap = out[4]["worst"]
    log(f"track_steps_batched witness: each stream of the K = 4 batch "
        f"bit-equal to a K = 4 batch of four copies of itself; the batch's "
        f"{gap:.3g} (m or rad) from single steps is its reduction order")
    out["copies_gap"] = gap
    one_dev = out[1]["device_batch"]
    log(f"track_steps_batched device time over one stream's: K = 2 "
        f"x{out[2]['device_batch'] / one_dev:.2f}, K = 4 "
        f"x{out[4]['device_batch'] / one_dev:.2f}")
    return out


MESH_KERNELS = ("slab_group_sums_f32", "slab_group_sums_compact",
                "slab_group_sums_q8", "block_histogram")


def _kernel_fns():
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import block_histogram
    from piccolo_tpu_torch.kernels.histogram import masked_histogram_counts
    from piccolo_tpu_torch.kernels.splat_hist import splat_block_counts

    return {fn.__name__: fn for fn in (
        slab.slab_group_sums_f32, slab.slab_group_sums_compact,
        slab.slab_group_sums_q8, block_histogram, masked_histogram_counts,
        splat_block_counts)}


def _zero_counts():
    for fn in _kernel_fns().values():
        fn.launches, fn.by_card = 0, {}


def _read_counts():
    return {k: dict(total=fn.launches, by_card=dict(fn.by_card))
            for k, fn in _kernel_fns().items()}


def _cards():
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh_2x2():
    """make_mesh(2, 2) over the visible cards: four distinct cards when
    four are visible, every shard on cuda:0 when one is."""
    from piccolo_tpu_torch.parallel import make_mesh

    cards = _cards()
    mesh = make_mesh(2, 2, devices=[cards[i % len(cards)] for i in range(4)])
    for (c, p), d in np.ndenumerate(mesh.devices):
        log(f"mesh shard (cand {c}, point {p}): {d} "
            f"({torch.cuda.get_device_name(d)})")
    return mesh


def _swap_is_a_tie(s_one, s_mesh, k1):
    """Whether the pairs that entered or left the top k1 of stage 1 between
    one device and the mesh lie within MESH_TIE_REL of the k1-th score in
    both; prints each such pair's two scores."""
    top_one = set(torch.sort(s_one, stable=True).indices[:k1].tolist())
    top_mesh = set(torch.sort(s_mesh, stable=True).indices[:k1].tolist())
    kth = float(torch.sort(s_one).values[k1 - 1])
    swapped = sorted(top_one ^ top_mesh)
    for i in swapped:
        log(f"  stage-1 pair {i}: one device {float(s_one[i])!r}, mesh "
            f"{float(s_mesh[i])!r}, k1-th score {kth!r}")
    return bool(swapped) and all(
        abs(float(s[i]) - kth) <= MESH_TIE_REL * kth
        for i in swapped for s in (s_one, s_mesh))


@contextlib.contextmanager
def _recording_stage2(calls, splats=None):
    """Stage 2's block histogram as the queries call it on winner-bin
    planes (a HistPlan's, the mesh's decoded keys), with each call's inputs
    kept in ``calls`` (the first of each card and shape), and the live
    splat's block counts (``refine.splat_block_counts``: the kernel pair on
    one card) likewise in ``splats``, a dict keyed by card and shapes: the
    wrappers still run and count."""
    from piccolo_tpu_torch.init import refine

    real, real_splat = refine.block_histogram, refine.splat_block_counts

    def recorded(ids, mask, num_bins=512):
        key = (ids.device.index, tuple(ids.shape), num_bins)
        if key not in calls:
            calls[key] = (ids.clone(), mask.clone())
        return real(ids, mask, num_bins)

    def recorded_splat(*args):
        xyz, trans = args[0], args[2]
        key = (xyz.device.index, trans.shape[0]) + tuple(args[6:])
        if splats is not None and key not in splats:
            splats[key] = tuple(a.clone() if isinstance(a, torch.Tensor)
                                else a for a in args)
        return real_splat(*args)

    refine.block_histogram = recorded
    refine.splat_block_counts = recorded_splat
    try:
        yield
    finally:
        refine.block_histogram = real
        refine.splat_block_counts = real_splat


def _mesh_kernel_rows(mesh, plans_m, img_init, stage2_calls, by_card,
                      n_queries):
    """Every kernel of the mesh path against its plain version on each
    shard's own card, at the shard's shapes: the group sums on every group
    of every shard's plan in each layout (counts exact, sums within phase
    kernels' tolerance), and the block histogram on each stage-2 call the
    mesh queries made on a cand group's lead card (bit-exact).  One row per
    kernel: its launches over the mesh queries (by card), its largest error
    (by card), and its times on the mesh's last card."""
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.kernels.block_histogram import (
        block_histogram,
        block_histogram_plain,
    )

    # kernel, plain version, TPU kernel's line, bytes and ~f32 operations a
    # real sample (phase_kernels, phase_layout_kernels)
    spec = {
        "f32": (slab.slab_group_sums_f32, slab.slab_group_sums_f32_plain,
                677, None, F32_OPS_PER_SAMPLE),
        "compact": (slab.slab_group_sums_compact,
                    slab.slab_group_sums_compact_plain, 689, 16, 54),
        "q8": (slab.slab_group_sums_q8, slab.slab_group_sums_q8_plain, 711,
               8, 59),
    }
    path = f"mesh 2x2 library queries ({n_queries}, phase 24)"
    rows = []
    for layout, (kernel, plain, line, per_real, ops_per) in spec.items():
        err, n_groups = {}, 0
        for (c, p), dev in np.ndenumerate(mesh.devices):
            plan = plans_m[layout].plans[c][p]
            table = slab.slab_table(img_init.to(dev), wrap=plan.wrap,
                                    window=plan.window)
            for g in range(len(plan.fields)):
                args = ((plan.fields[g], plan.windows[g]) if layout == "f32"
                        else (plan.fields[g], plan.tps[g], plan.windows[g]))
                got = kernel(table, *args, plan.window)
                want = plain(table, *args, plan.window)
                torch.cuda.synchronize(dev)
                if not torch.equal(got[1], want[1]):
                    raise AssertionError(
                        f"mesh {layout} slab kernel counts differ from the "
                        f"plain version on shard ({c}, {p}), {dev}, group {g}")
                torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                                           atol=1e-6)
                e = float((got[0] - want[0]).abs().max())
                err[str(dev)] = max(err.get(str(dev), 0.0), e)
                n_groups += 1
        f, w = args[0], args[-1]
        nb, _, _ = f.shape
        if layout == "f32":
            samples, pads, _, n_win = _f32_plan_stats(f, w)
            nbytes, _ = _f32_bytes(samples, pads, nb, n_win, plan.window)
        else:
            real = (((f[:, 0] >> 23) & 0x1FF) < plan.window if layout == "q8"
                    else f[:, 0] >= 0)
            samples = int(real.sum())
            n_win = int(torch.unique(w).numel())
            nbytes = (samples * per_real + nb * 4 + n_win * plan.window * 48
                      + nb * 4 + 2 * 128 * 4)
        bound_ms, bound_by = _bound(nbytes, samples * ops_per)
        with torch.cuda.device(dev):  # the last shard's group, on its card
            ms = cuda_ms(lambda: kernel(table, *args, plan.window))
            plain_ms = cuda_ms(lambda: plain(table, *args, plan.window))
        name = kernel.__name__
        rows.append(dict(
            name=f"{name}.mesh", route="cuda",
            source="piccolo_tpu_torch/kernels/csrc/slab_sampling.cu",
            replaces=f"piccolo_tpu/kernels/slab_sampling.py:{line}",
            path=path, launches=sum(by_card.get(name, {}).values()),
            launches_per_query=sum(by_card.get(name, {}).values()) / n_queries,
            launches_by_card=by_card.get(name, {}),
            max_abs_err=max(err.values()), max_abs_err_by_card=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
        log(f"mesh {layout} slab kernel vs plain on all {n_groups} groups of "
            f"the 4 shards' plans: counts exact, max |sum err| by card {err}; "
            f"on {dev}, group {g} of shard ({c}, {p}) (nb={nb}, {samples} "
            f"real samples): {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms")
    if not {k[0] for k in stage2_calls} >= {d.index for d in mesh.devices[:, 0]}:
        raise AssertionError(f"stage 2 recorded on cards "
                             f"{sorted({k[0] for k in stage2_calls})} only")
    err = {}
    for (card, shape, nbins), (ids, mask) in sorted(stage2_calls.items()):
        got = block_histogram(ids, mask, nbins)
        want = block_histogram_plain(ids, mask, nbins)
        torch.cuda.synchronize(ids.device)
        if not torch.equal(got, want):
            raise AssertionError(f"mesh block histogram differs from the "
                                 f"plain version on cuda:{card} at {shape}")
        err[str(ids.device)] = max(err.get(str(ids.device), 0.0),
                                   float((got - want).abs().max()))
    (card, shape, nbins), (ids, mask) = max(
        stage2_calls.items(), key=lambda kv: (kv[0][1][0], kv[0][0]))
    B = shape[0]
    flat = (torch.arange(B, device=ids.device)[:, None] * nbins
            + ids).reshape(-1)
    bound_ms, bound_by = _bound(ids.numel() * 8 + B * nbins * 4,
                                ids.numel() * 2)
    with torch.cuda.device(ids.device):
        ms = cuda_ms(lambda: block_histogram(ids, mask, nbins))
        plain_ms = cuda_ms(lambda: block_histogram_plain(ids, mask, nbins))
        library_ms = cuda_ms(lambda: torch.bincount(
            flat, weights=mask.reshape(-1), minlength=B * nbins))
    extras = _bh_extras(ids, nbins)
    stats = _run_stats(ids, mask, nbins)
    got = by_card.get("block_histogram", {})
    rows.append(dict(
        name="block_histogram.mesh", route="cuda",
        source="piccolo_tpu_torch/kernels/csrc/block_histogram.cu",
        replaces="piccolo_tpu/kernels/histogram_mxu.py:90", path=path,
        launches=sum(got.values()),
        launches_per_query=sum(got.values()) / n_queries,
        launches_by_card=got, max_abs_err=max(err.values()),
        max_abs_err_by_card=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms, **extras))
    log(f"mesh block histogram vs plain on {len(stage2_calls)} recorded "
        f"stage-2 calls (card, shape): {sorted(k[:2] for k in stage2_calls)}: "
        f"bit-exact; on {ids.device} at {shape}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bincount {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms, empty launch {extras['empty_launch_ms']:.4f} "
        f"ms, threads {extras['threads']}; counted "
        f"{stats['counted_share']:.3f} of entries, "
        f"{stats['counted_per_run']:.2f} a run")
    return rows


def phase_mesh(room, dev):
    """The library room over make_mesh(2, 2): (a) the sharded query on
    every stage-1 route (f32, compact and q8 sharded plans, the gather
    engine) and both stage-2 routes (sharded HistPlan, live splat) against
    the single-device query on the same inputs at MESH_KW: equal starts
    (or a stage-1 tie, MESH_TIE_REL), equal winners, cand_loss within
    MESH_LOSS_BOUND; (b) the full budget (20 -> 6 starts x 100): t_err
    under 0.05 m, and the graphed descent bit-equal to the eager one;
    launches of every kernel on every card over (a) and (b); (c)
    MESH_QUERIES sharded and single-device queries in turns, s/query p50
    and p90 of each."""
    from piccolo_tpu_torch import build_grid_plan, localize_query
    from piccolo_tpu_torch import parallel as P
    from piccolo_tpu_torch.kernels.slab_sampling import (
        make_pairs,
        slab_pair_scores,
    )
    from piccolo_tpu_torch.parallel import fused as F
    from piccolo_tpu_torch.pipeline import _grid_scores

    r = room
    mesh = _mesh_2x2()
    t0 = time.time()
    layouts = {"f32": {}, "compact": dict(compact=True),
               "q8": dict(compact=True, quant=True)}
    plans_m = {k: P.shard_grid_plan(mesh, r["xyz_d"], r["rgb_d"], r["mask_d"],
                                    r["trans_real"], r["rot"], 256, 512, **kw)
               for k, kw in layouts.items()}
    hplan_m = P.shard_hist_plan(mesh, r["hplan"])
    cloud = P.shard_cloud(mesh, r["xyz_d"], r["rgb_d"], r["mask_d"])
    torch.cuda.synchronize()
    log(f"mesh plans built in {time.time() - t0:.2f} s; bytes by card "
        f"(plan_exact_bytes before the build): "
        f"{ {k: v.card_bytes for k, v in plans_m.items()} }; HistPlan "
        f"{hplan_m.nbytes} B in {len(hplan_m.planes)} parts")
    for k, v in plans_m.items():
        held = {}
        for (c, p), d in np.ndenumerate(mesh.devices):
            held[str(d)] = held.get(str(d), 0) + v.plans[c][p].nbytes
        if held != v.card_bytes:
            raise AssertionError(f"{k} sharded plan holds {held}, sized "
                                 f"{v.card_bytes}")
    plans_1 = dict(f32=r["plan"], **{
        k: build_grid_plan(r["xyz_d"], r["rgb_d"], r["mask_d"],
                           r["trans_real"], r["rot"], 256, 512, device=dev,
                           **layouts[k]) for k in ("compact", "q8")})
    routes = [("f32", "HistPlan"), ("compact", "live splat"),
              ("q8", "live splat"), ("gather engine", "live splat")]
    def one_query(img_init, img_main, s1, s2, sharded, eager=False, **kw):
        args = (img_init, img_main)
        grid = (r["trans"], r["rot"], r["valid"], r["lo"], r["hi"])
        if sharded:
            return P.localize_query_sharded(
                mesh, *args, cloud, None, *grid, plan=plans_m.get(s1),
                hist_plan=hplan_m if s2 == "HistPlan" else None,
                _eager=eager, **kw)
        return localize_query(
            *args, r["xyz_d"], r["rgb_d"], *grid, r["mask_d"], masked=True,
            plan=plans_1.get(s1),
            hist_plan=r["hplan"] if s2 == "HistPlan" else None, device=dev,
            _eager=eager, **kw)

    def stage1(img_init, s1, sharded):
        """Stage 1's scores on either path (for a differing start)."""
        trans = torch.as_tensor(r["trans"], device=dev)
        rot = torch.as_tensor(r["rot"], device=dev)
        T, R = trans.shape[0], rot.shape[0]
        valid = torch.repeat_interleave(torch.as_tensor(r["valid"],
                                                        device=dev), R)
        pt, pr = make_pairs(trans, rot)
        if sharded and s1 in plans_m:
            sc = F._stage1_slab(mesh, plans_m[s1], cloud, img_init, False)
        elif sharded:
            m = 2 * 16
            sc = F._stage1_gather(mesh, cloud, img_init,
                                  F._pad_clone_rows(pt, m),
                                  F._pad_clone_rows(pr, m), 16, False)
        elif s1 in plans_1:
            sc = slab_pair_scores(img_init, plans_1[s1])
        else:
            return _grid_scores(img_init, r["xyz_d"], r["rgb_d"], pt, pr,
                                valid, r["mask_d"], 16)
        sc = sc[:T * R]
        sc = torch.cat([sc, torch.full((T * R - sc.shape[0],), math.inf,
                                       device=dev)])
        return torch.where(valid, sc, torch.full_like(sc, math.inf))

    by_card = {}  # by kernel and card, over the mesh queries alone

    def on_mesh(*a, **kw):
        """A mesh query with every count set to 0 just before it and read
        just after (the single-device queries are not counted)."""
        _zero_counts()
        out = one_query(*a, **kw)
        torch.cuda.synchronize()
        for name, got in _read_counts().items():
            held = by_card.setdefault(name, {})
            for card, n in got["by_card"].items():
                held[card] = held.get(card, 0) + n
        return out

    checks, stage2_calls = [], {}
    gt_t, _, img_init, img_main = _query_images(500, r["xyz"], r["rgb"], dev)
    for s1, s2 in routes:
        with _recording_stage2(stage2_calls):
            got = on_mesh(img_init, img_main, s1, s2, True, **MESH_KW)
        want = one_query(img_init, img_main, s1, s2, False, **MESH_KW)
        same = (torch.equal(got.start_t, want.start_t)
                and torch.equal(got.start_ypr, want.start_ypr))
        if not same:
            log(f"mesh, stage 1 {s1}, stage 2 {s2}: starts differ")
            if not _swap_is_a_tie(stage1(img_init, s1, False),
                                  stage1(img_init, s1, True),
                                  MESH_KW["num_intermediate"]):
                raise AssertionError(f"mesh {s1}/{s2}: starts differ beyond "
                                     "a stage-1 tie")
        elif int(got.winner) != int(want.winner):
            raise AssertionError(f"mesh {s1}/{s2}: winner {int(got.winner)} "
                                 f"against {int(want.winner)}")
        d = float((got.cand_loss - want.cand_loss).abs().max())
        if same and not d <= MESH_LOSS_BOUND:
            raise AssertionError(f"mesh {s1}/{s2}: cand_loss {d} apart")
        checks.append(dict(stage1=s1, stage2=s2, same_starts=same,
                           winner=int(got.winner), cand_loss_gap=d))
        log(f"mesh, stage 1 {s1}, stage 2 {s2} ({MESH_KW}): starts "
            f"{'equal' if same else 'a stage-1 tie'}, winner "
            f"{int(got.winner)} = {int(want.winner)}, cand_loss within {d:.3g}")

    full = dict(num_intermediate=20, num_input=6, num_iter=100, lr=0.1,
                patience=5, factor=0.8)
    graphed = on_mesh(img_init, img_main, "f32", "HistPlan", True, **full)
    eager = on_mesh(img_init, img_main, "f32", "HistPlan", True, eager=True,
                    **full)
    if not (torch.equal(graphed.cand_t, eager.cand_t)
            and torch.equal(graphed.cand_ypr, eager.cand_ypr)
            and torch.equal(graphed.cand_loss, eager.cand_loss)):
        raise AssertionError("mesh: graphed and eager descents differ")
    t_err = float(np.linalg.norm(graphed.t.cpu().numpy() - gt_t))
    launches = {k: dict(total=sum(v.values()), by_card=v)
                for k, v in by_card.items()}
    log(f"mesh, full budget (20 -> 6 x 100), f32 plan + HistPlan: t_err "
        f"{t_err:.4f} m; graphed and eager bit-equal; launches by card over "
        f"the {len(routes) + 2} mesh queries {launches}")
    if not t_err < 0.05:
        raise AssertionError(f"mesh: t_err {t_err} m")
    # the slab kernels run on every shard's card, the block histogram on
    # every cand group's lead card (stage 2 runs there)
    leads = {d.index for d in mesh.devices[:, 0]}
    for name in MESH_KERNELS:
        want = leads if name == "block_histogram" else {
            d.index for d in mesh.cards()}
        missing = sorted(want - set(by_card.get(name, {})))
        if missing:
            raise AssertionError(f"{name} never launched on cards {missing} "
                                 "of the mesh")
    rows = _mesh_kernel_rows(mesh, plans_m, img_init, stage2_calls, by_card,
                             len(routes) + 2)
    del stage2_calls

    secs = {True: [], False: []}
    one_query(img_init, img_main, "f32", "HistPlan", False, **full)
    for i in range(MESH_QUERIES):
        _, _, ii, im = _query_images(600 + i, r["xyz"], r["rgb"], dev)
        for sharded in ((True, False) if i % 2 == 0 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.time()
            q = one_query(ii, im, "f32", "HistPlan", sharded, **full)
            q.t.cpu()
            secs[sharded].append(time.time() - t0)
    (m50, m90), (o50, o90) = _percentiles(secs[True]), _percentiles(secs[False])
    profile_query(f"library, mesh 2x2 over {len(mesh.cards())} card(s)",
                  lambda: one_query(ii, im, "f32", "HistPlan", True, **full),
                  m50)
    log(f"mesh 2x2 over {', '.join(mesh.fingerprint())}: s/query p50 "
        f"{m50:.4f} p90 {m90:.4f} against one device p50 {o50:.4f} p90 "
        f"{o90:.4f} ({MESH_QUERIES} each, in turns); all mesh "
        f"{[round(v, 4) for v in secs[True]]}, one device "
        f"{[round(v, 4) for v in secs[False]]}")
    return dict(mesh=mesh.fingerprint(), checks=checks, t_err=t_err,
                launches=launches, mesh_s=(m50, m90), one_s=(o50, o90),
                rows=rows)


def phase_mesh_cli_serving(cli_tree, dev):
    """Two or more cards: configs/stanford.ini through the CLI with
    n_devices=all against the same run on one card (the route names the
    mesh, the same accuracy); then LocalizeService on one card, with
    n_devices=all and with query_devices=all on the CLI room, under the
    shipped config and with sharpen_color=False (stage 1 on the slab
    plans): every request bit-equal to _run_fused on its own card, total_s
    p50 and p90 of SERVED_REQUESTS, and requests per second, total_s p50
    and the process's host CPU seconds a wall second from 4 concurrent
    clients."""
    from piccolo_tpu_torch.config import apply_overrides, parse_ini
    from piccolo_tpu_torch.data import read_stanford
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.harness.localize import _run_fused
    from piccolo_tpu_torch.main import main as cli_main
    from piccolo_tpu_torch.serve import LocalizeService

    out = {}
    for label, ov in (("one card", ""),
                      ("n_devices=all", f",n_devices={MESH_ALL}")):
        log_dir = os.path.join(os.path.dirname(cli_tree), "log_mesh_" +
                               label.replace(" ", "_").replace("=", "_"))
        buf = io.StringIO()
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(buf):
                acc = cli_main(["--config", CONFIG, "--log", log_dir,
                                "--no-tensorboard", "--device", dev.type,
                                "--override", f"data_root={cli_tree}{ov}"])
        except Exception:
            print(buf.getvalue()[-6000:], flush=True)
            raise
        routes = sorted({ln.split(":", 1)[1].strip()
                         for ln in buf.getvalue().splitlines()
                         if ln.startswith("route :")})
        rows = _csv_rows(log_dir)
        out[label] = dict(acc=acc, routes=routes,
                          s=float(np.median([float(x[9]) for x in rows])),
                          t_err=[float(x[7]) for x in rows],
                          wall=time.time() - t0)
        log(f"mesh cli, stanford.ini, {label}: accuracy {acc}; routes "
            f"{routes}; median time (s) {out[label]['s']:.4f}; t_err (m) "
            f"{[round(v, 4) for v in out[label]['t_err']]}")
    if not all(rt.startswith("mesh") for rt in out["n_devices=all"]["routes"]):
        raise AssertionError("n_devices=all: a route without the mesh")
    if out["n_devices=all"]["acc"] != out["one card"]["acc"]:
        raise AssertionError("n_devices=all changed the CLI's accuracy")

    panos = sorted(glob.glob(os.path.join(cli_tree, "stanford", "pano",
                                          "area_1", "*.png")))
    pcd = os.path.join(cli_tree, "stanford", "pcd_not_aligned", "area_1",
                       "office_1.txt")
    xyz, rgb = (a.astype(np.float32) for a in read_stanford(pcd, 1))
    images = [imread_rgb(p) for p in panos]
    services = [(f"{name}{extra}", ",".join(x for x in (ov, sharp) if x))
                for extra, sharp in (("", ""), (", sharpen_color=False",
                                                "sharpen_color=False"))
                for name, ov in (("one card", ""),
                                 ("n_devices=all", f"n_devices={MESH_ALL}"),
                                 ("query_devices=all",
                                  f"query_devices={MESH_ALL}"))]
    for label, ov in services:
        cfg = parse_ini(CONFIG)
        svc = LocalizeService(apply_overrides(cfg, ov) if ov else cfg,
                              device=dev)
        t0 = time.time()
        svc.load_room(xyz, rgb, name="office_1", warm_shape=(512, 1024))
        load_s = time.time() - t0
        totals, used = [], set()
        for i in range(SERVED_REQUESTS):
            img = images[i % len(images)]
            got = svc.localize(img)
            cache = svc._rooms["office_1"][got["device_index"]]
            ii, im, ru, _ = svc._prepare(img, cache)
            res, _ = _run_fused(ii, im, cache, ru, svc.cfg, svc.init_dict,
                                cache["grids"], svc.mesh, sync_plans=True)
            if not (np.array_equal(got["t"], res.t.cpu().numpy())
                    and got["loss"] == float(res.loss)):
                raise AssertionError(f"served {label}: request {i} differs "
                                     "from _run_fused on its card")
            totals.append(got["total_s"])
            used.add(str(cache["device"]))
        n_req = 4 * len(images)
        errors, busy, thread_cpu, held = [], [], {}, {}
        held_lock = threading.Lock()

        def client(k):
            c0 = time.thread_time()
            try:
                for j in range(len(images)):
                    got = svc.localize(images[(k + j) % len(images)])
                    busy.append(got["total_s"])
                    with held_lock:
                        i = got["device_index"]
                        held[i] = held.get(i, 0.0) + got["time_s"]
            except Exception as exc:  # reported below
                errors.append(exc)
            thread_cpu[k] = time.thread_time() - c0

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        cpu0, t0 = os.times(), time.time()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.time() - t0
        cpu1 = os.times()
        # the process's CPU seconds a wall second: near 1 when one thread
        # at a time runs Python (the host dispatch holds the GIL)
        cores = ((cpu1.user - cpu0.user) + (cpu1.system - cpu0.system)) / wall
        if errors:
            raise errors[0]
        p50, p90 = _percentiles(totals)
        c50, _ = _percentiles(busy)
        threads_s = [round(thread_cpu[k], 2) for k in sorted(thread_cpu)]
        cards_s = {i: round(v, 2) for i, v in sorted(held.items())}
        out[f"served {label}"] = dict(p50=p50, p90=p90, rps=n_req / wall,
                                      busy_p50=c50, host_cores=cores,
                                      cards=sorted(used), load_s=load_s,
                                      thread_cpu_s=threads_s,
                                      time_s_by_card=cards_s)
        log(f"mesh serving, {label}: warmed in {load_s:.2f} s on "
            f"{sorted(used)}; {SERVED_REQUESTS} requests bit-equal to "
            f"_run_fused on their card, total_s p50 {p50:.4f} p90 {p90:.4f}; "
            f"4 concurrent clients x {len(images)} requests: "
            f"{n_req / wall:.3f} requests/s, total_s p50 {c50:.4f}, host "
            f"CPU {cores:.2f} s a wall second; each client thread's host "
            f"CPU s {threads_s}; time_s summed by query card {cards_s} in "
            f"{wall:.2f} s")
        del svc
        torch.cuda.empty_cache()
    return out


def phase_mesh_stretch(dev):
    """Two or more cards: scripts/measure_stretch.py's room (1.02 M points,
    4096x2048 main image, 1024x512 init image, 54 x 8 pairs, live splat,
    6 x 100 descent), its stage 1 through the harness's admission: on one
    card, then over the meshes (1, n), (2, n / 2) and (n, 1) of the n
    visible cards (up to 4).  Each card's plan bytes (plan_exact_bytes of
    the sizing pass) are printed before its streams are built; then 1
    warm-up and STRETCH_QUERIES timed queries, s/query and t_err."""
    from piccolo_tpu_torch import localize_query
    from piccolo_tpu_torch.config import make_config
    from piccolo_tpu_torch.harness import localize as hl
    from piccolo_tpu_torch.init.candidates import default_init_dict
    from piccolo_tpu_torch.parallel import (
        localize_query_sharded,
        make_mesh,
        shard_cloud,
    )
    from piccolo_tpu_torch.testing import make_room, random_pose_inside
    from piccolo_tpu_torch.testing import render_at

    cards = _cards()[:4]
    n = len(cards)
    rng = np.random.default_rng(7)
    xyz, rgb = make_room(rng, n_per_wall=170000, size=SIZE, texture="checker")
    xyz_d, rgb_d, mask_d = hl._pad_cloud(xyz, rgb, dev)
    lo, hi = hl._order_bounds(xyz, 0.05)
    init = default_init_dict(xy_only=True, yaw_only=True, num_yaw=8,
                             num_trans=50, z_prior=None, num_split_h=4,
                             num_split_w=4)
    grids = hl._FusedGrids(xyz, init, dev)
    cfg = make_config(dataset="Stanford2D-3D-S", slab_init="auto",
                      slab_plan_cache=False, slab_background_build=False)
    cache = dict(xyz=xyz_d, rgb=rgb_d, mask=mask_d, device=dev)
    kw = dict(num_intermediate=20, num_input=6, num_iter=100, lr=0.1,
              patience=5, factor=0.8)
    imgs = []
    for i in range(STRETCH_QUERIES + 1):
        gt_t, gt_ypr = random_pose_inside(np.random.default_rng(700 + i), SIZE)
        main_img = render_at(xyz, rgb, gt_t, gt_ypr, (2048, 4096), device=dev)
        imgs.append((gt_t, main_img[::4, ::4].contiguous(), main_img))
    log(f"stretch room: {xyz.shape[0]} points padded to {xyz_d.shape[0]}, "
        f"{grids.n_trans} x {int(grids.rot.shape[0])} pairs, 4096x2048 main, "
        f"1024x512 init")
    shapes = [None, (1, n), (2, n // 2), (n, 1)] if n >= 4 else \
        [None, (1, n), (n, 1)]
    out = {}
    for shape in shapes:
        mesh = None if shape is None else make_mesh(*shape, devices=cards)
        label = "one card" if mesh is None else f"mesh {shape[0]}x{shape[1]}"
        cloud = None if mesh is None else shard_cloud(mesh, xyz_d, rgb_d,
                                                      mask_d)
        t0 = time.time()
        if mesh is None:
            plan = hl._maybe_slab_plan(cfg, cache, grids, imgs[0][1],
                                       sync=True)
            card_bytes = {str(dev): 0 if plan is None else plan.nbytes}
        else:
            plan = hl._maybe_sharded_slab_plan(cfg, cache, grids, imgs[0][1],
                                               mesh)
            card_bytes = None if plan is None else plan.card_bytes
        torch.cuda.synchronize()
        build_s = time.time() - t0
        layout = None if plan is None else (
            "q8" if plan.quant else "compact" if plan.compact else "f32")
        log(f"stretch, {label}: {layout} plan, bytes by card "
            f"{card_bytes}, built in {build_s:.2f} s")
        # a plan build that runs out of memory falls back to the gather
        # engine and only prints: the ladder's admission must hold
        if plan is None and hl._slab_admission(cfg, cache, grids,
                                               imgs[0][1]) is not None:
            raise AssertionError(f"stretch, {label}: the admitted plan fell "
                                 "back to the gather engine")

        def query(k):
            _, ii, im = imgs[k]
            if mesh is None:
                n_real = grids.n_trans * int(grids.rot.shape[0])
                return localize_query(
                    ii, im, xyz_d, rgb_d, grids.trans, grids.rot, grids.valid,
                    lo, hi, mask_d, masked=True, plan=plan,
                    plan_tail="xla" if plan is not None
                    and plan.n_pairs < n_real else "pad", device=dev, **kw)
            return localize_query_sharded(
                mesh, ii, im, cloud, None, grids.trans, grids.rot,
                grids.valid, lo, hi, plan=plan, **kw)

        query(0)
        secs, errs = [], []
        for k in range(1, STRETCH_QUERIES + 1):
            torch.cuda.synchronize()
            t0 = time.time()
            res = query(k)
            t = res.t.cpu().numpy()
            secs.append(time.time() - t0)
            errs.append(float(np.linalg.norm(t - imgs[k][0])))
        peak = {str(d): torch.cuda.max_memory_allocated(d)
                for d in (mesh.cards() if mesh is not None else [dev])}
        out[label] = dict(s=float(np.median(secs)), secs=secs, t_err=errs,
                          layout=layout, card_bytes=card_bytes,
                          build_s=build_s, peak=peak)
        log(f"stretch, {label}: s/query {[round(v, 4) for v in secs]} "
            f"(median {out[label]['s']:.4f}); t_err (m) "
            f"{[round(v, 4) for v in errs]}; peak memory by card {peak}")
        if not np.median(errs) < 0.05:
            raise AssertionError(f"stretch {label}: t_err {errs}")
        for k in [k for k in cache if isinstance(k, tuple)]:
            cache.pop(k)
        del plan, cloud
        torch.cuda.empty_cache()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
    return out


# the routing decisions (phases 32-35): the value's pick must take less
# than this multiple of the time of the route it refused, both measured here
ROUTING_SLOWER = 2.0
ROUTING = []  # one row per decision and shape


def _walls(fns, reps=2):
    """Median host seconds of each synchronised call, after one warm-up
    each, in turns (ABBA, ``reps`` times)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    keys = list(fns)
    out = {k: [] for k in keys}
    for order in (keys, keys[::-1]) * reps:
        for k in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            out[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in out.items()}


def _first_groups(plan, n):
    """The plan cut to its first ``n`` groups (and their pairs)."""
    return dataclasses.replace(
        plan, fields=plan.fields[:n], windows=plan.windows[:n],
        tps=plan.tps[:n], n_pairs=min(plan.n_pairs, n * 128))


def phase_routing(label, r, dev):
    """The five values that choose the card's route, at one shape: each
    decision's pick beside the route it refused, both timed here in turns
    (host clock around synchronised calls); fails when the pick takes
    ROUTING_SLOWER times the other's time or more.

    ``r`` holds the room's padded cloud (xyz_d, rgb_d, mask_d), clamp box
    (lo, hi), real grid rows (trans, rot) and the grid padded as the
    pipeline pads it (grid: a multiple of 64 rows), the query's images
    (img_init, img_main) and colours (rgb), whether the query re-bakes the
    plan (refresh), and the plan the route built (plan).
      grid_chunk: the gather engine over the padded grid's pairs, as the
        pipeline scores them, at gather_chunk's chunk and at the other of
        16 and 32 (and whether the scores are bit-equal);
      slab_worthwhile: stage 1 on the plan (its layout, re-bake fused when
        the query re-bakes) against the gather engine;
      plan fraction: the layout the budget admitted against the next one
        down the ladder (f32 -> compact -> q8; q8 -> the gather engine), on
        the plan's first two groups;
      plan geometry: the plan's (window, block) against the other, on its
        first two groups;
      descent table: a graphed 6 x 100 descent from the first six pairs on
        the f32 and on the bf16 table."""
    from piccolo_tpu_torch.init.refine import _score_pairs, gather_chunk
    from piccolo_tpu_torch.kernels import slab_sampling as slab
    from piccolo_tpu_torch.ops.sampling import resolve_descent_table
    from piccolo_tpu_torch.solver import descend_starts

    img, plan = r["img_init"], r["plan"]
    H, W = img.shape[0], img.shape[1]
    n_points = int(r["mask_d"].shape[0])
    pair_t, pair_r = slab.make_pairs(r["trans"], r["rot"])
    n_pairs = int(pair_t.shape[0])
    grid_t, grid_r = slab.make_pairs(r["grid"], r["rot"])
    palette = r["rgb"] if r["refresh"] else None
    layout = "q8" if plan.quant else ("compact" if plan.compact else "f32")

    def decide(name, pick, fns, **extra):
        t = _walls(fns)
        other = next(k for k in fns if k != pick)
        row = dict(shape=label, decision=name, pick=pick,
                   pick_ms=1e3 * t[pick], refused=other,
                   refused_ms=1e3 * t[other], **extra)
        ROUTING.append(row)
        log(f"routing, {label}: {name}: {pick} {row['pick_ms']:.3f} ms, "
            f"refused {other} {row['refused_ms']:.3f} ms"
            + (f"; {extra}" if extra else ""))
        if t[pick] >= ROUTING_SLOWER * t[other]:
            raise AssertionError(f"routing, {label}: {name} picks {pick}, "
                                 f"{ROUTING_SLOWER}x or more slower than "
                                 f"{other}: {row}")

    def gather(c):
        return lambda: _score_pairs(img, r["xyz_d"], r["rgb_d"], grid_t,
                                    grid_r, r["mask_d"], c)

    def stage1(p):
        return lambda: slab.slab_pair_scores(img, p, palette)

    chunk = gather_chunk(n_points, dev)
    c_other = 32 if chunk == 16 else 16
    decide("grid_chunk", f"chunk {chunk}",
           {f"chunk {chunk}": gather(chunk), f"chunk {c_other}":
            gather(c_other)},
           bit_equal=bool(torch.equal(gather(chunk)(), gather(c_other)())))
    worth = slab.slab_worthwhile(n_pairs, n_points, H, W, r["refresh"],
                                 compact=plan.compact, device=dev)
    decide("slab_worthwhile", "slab plan" if worth else "gather engine",
           {"slab plan": stage1(plan), "gather engine": gather(chunk)},
           layout=layout, pairs=n_pairs, plan_pairs=plan.n_pairs)

    n = min(2, len(plan.fields))
    head = _first_groups(plan, n)

    def build(**kw):
        return _first_groups(slab.build_grid_plan(
            r["xyz_d"], r["rgb_d"], r["mask_d"], r["trans"], r["rot"], H, W,
            tp_is_pid=r["refresh"] and kw.get("compact", False),
            device=dev, groups=(0, n), **kw), n)

    cap = slab.default_plan_bytes_cap(dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    if layout == "q8":
        fns = {"q8 plan": stage1(head), "gather engine": gather(chunk)}
    else:
        down = "compact" if layout == "f32" else "q8"
        fns = {f"{layout} plan": stage1(head),
               f"{down} plan": stage1(build(compact=True,
                                            quant=down == "q8"))}
    decide("plan fraction", next(iter(fns)), fns, cap=cap,
           plan_bytes=plan.nbytes, card_peak_so_far=peak, groups=n)
    del fns

    geo = (plan.window, plan.block)
    if geo != slab.resolve_plan_geometry(n_points, H, W, device=dev):
        raise AssertionError(f"routing, {label}: the plan's geometry {geo} "
                             "is not the resolver's")
    other = (256, 512) if geo == (128, 1024) else (128, 1024)
    alt = build(compact=plan.compact, quant=plan.quant, window=other[0],
                block=other[1])
    decide("plan geometry", f"{geo[0]}x{geo[1]}",
           {f"{geo[0]}x{geo[1]}": stage1(head),
            f"{other[0]}x{other[1]}": stage1(alt)}, layout=layout, groups=n,
           density=n_points / ((H + 1) * (W + 1)))
    del alt
    torch.cuda.empty_cache()

    img_main = r["img_main"]
    Hm, Wm = img_main.shape[0], img_main.shape[1]
    lo, hi = (torch.as_tensor(np.asarray(b, np.float32), device=dev)
              for b in r["bounds"])

    def descent(dtype):
        return lambda: descend_starts(
            img_main, r["xyz_d"], r["rgb_d"], pair_t[:6], pair_r[:6], lo, hi,
            r["mask_d"], 100, 0.1, 5, 0.8, table_dtype=dtype)

    decide("descent table", resolve_descent_table("auto", Hm, Wm, dev),
           {"float32": descent("float32"), "bfloat16": descent("bfloat16")},
           table_mb_f32=(Hm + 1) * (Wm + 1) * 48 / 1e6)


def _routing_inputs(dev, xyz_d, rgb_d, mask_d, bounds, grid, n_trans, rot,
                    img_init, img_main, rgb, refresh, plan):
    f32 = torch.float32
    grid = torch.as_tensor(grid, device=dev, dtype=f32)
    return dict(xyz_d=xyz_d, rgb_d=rgb_d, mask_d=mask_d, bounds=bounds,
                grid=grid, trans=grid[:n_trans],
                rot=torch.as_tensor(rot, device=dev, dtype=f32),
                img_init=torch.as_tensor(img_init, device=dev, dtype=f32),
                img_main=torch.as_tensor(img_main, device=dev, dtype=f32),
                rgb=torch.as_tensor(rgb, device=dev, dtype=f32),
                refresh=refresh, plan=plan)


def phase_routing_library(room, dev):
    """Phase 32: the routing decisions at the library room (phase 3's plan,
    the f32 layout, no re-bake)."""
    _, _, img_init, img_main = _query_images(100, room["xyz"], room["rgb"],
                                             dev)
    phase_routing("library", _routing_inputs(
        dev, room["xyz_d"], room["rgb_d"], room["mask_d"],
        (room["lo"], room["hi"]), room["trans"], len(room["trans_real"]),
        room["rot"], img_init, img_main, room["rgb_d"], False, room["plan"]),
        dev)


def phase_routing_cli(cli, dev):
    """Phase 33: the routing decisions at the CLI's room under the shipped
    configs/stanford.ini: the plan its ladder admits (sharpen_color: the
    re-bake on every query), built as run A builds it."""
    from piccolo_tpu_torch.harness import localize as hl

    grids = cli["grids"]
    cache = dict(xyz=cli["xyz_d"], rgb=cli["rgb_d"], mask=cli["mask_d"],
                 device=dev)
    img_init = torch.as_tensor(cli["img_init"], device=dev)
    plan = hl._maybe_slab_plan(cli["cfg"], cache, grids, img_init, sync=True)
    if plan is None:
        raise AssertionError("the shipped stanford.ini admitted no plan")
    phase_routing("stanford.ini", _routing_inputs(
        dev, cli["xyz_d"], cli["rgb_d"], cli["mask_d"], cli["bounds"],
        grids.trans, grids.n_trans, grids.rot, img_init, cli["img_main"],
        cli["rgb_used"], True, plan), dev)


def phase_routing_omni(o, dev):
    """Phase 34: the routing decisions at the OmniScenes room (phase 13's
    plan)."""
    room, grids = o["room"], o["room"]["grids"]
    phase_routing("omniscenes.ini", _routing_inputs(
        dev, room["xyz"], room["rgb"], room["mask"], (room["lo"], room["hi"]),
        grids.trans, grids.n_trans, grids.rot, o["img_init"], o["img_main"],
        o["rgb_used"], o["rgb_used"] is not room["rgb"], o["plan"]), dev)


def phase_routing_stretch(dev):
    """Phase 35: scripts/measure_stretch.py's room (1.02 M points, 4096x2048
    main, 1024x512 init, 50 trans x 8 yaws) on one card: its plan through
    the harness's admission, which must be built (a build that runs out of
    memory falls back to the gather engine), then the routing decisions."""
    from piccolo_tpu_torch.config import make_config
    from piccolo_tpu_torch.harness import localize as hl
    from piccolo_tpu_torch.init.candidates import default_init_dict
    from piccolo_tpu_torch.testing import make_room, random_pose_inside
    from piccolo_tpu_torch.testing import render_at

    rng = np.random.default_rng(7)
    xyz, rgb = make_room(rng, n_per_wall=170000, size=SIZE, texture="checker")
    xyz_d, rgb_d, mask_d = hl._pad_cloud(xyz, rgb, dev)
    init = default_init_dict(xy_only=True, yaw_only=True, num_yaw=8,
                             num_trans=50, z_prior=None, num_split_h=4,
                             num_split_w=4)
    grids = hl._FusedGrids(xyz, init, dev)
    gt_t, gt_ypr = random_pose_inside(np.random.default_rng(700), SIZE)
    img_main = render_at(xyz, rgb, gt_t, gt_ypr, (2048, 4096), device=dev)
    img_init = img_main[::4, ::4].contiguous()
    cfg = make_config(dataset="Stanford2D-3D-S", slab_init="auto",
                      slab_plan_cache=False, slab_background_build=False)
    cache = dict(xyz=xyz_d, rgb=rgb_d, mask=mask_d, device=dev)
    adm = hl._slab_admission(cfg, cache, grids, img_init)
    torch.cuda.synchronize()
    t0 = time.time()
    plan = hl._maybe_slab_plan(cfg, cache, grids, img_init, sync=True)
    torch.cuda.synchronize()
    log(f"stretch room, one card: admission {adm}; "
        + ("no plan" if plan is None else
           f"{plan.nbytes} B plan (compact {plan.compact}, quant "
           f"{plan.quant}, window {plan.window}) built in "
           f"{time.time() - t0:.2f} s"))
    if adm is None or plan is None:
        raise AssertionError(f"stretch room: admission {adm}, plan {plan}")
    if plan.n_pairs < grids.n_trans * int(grids.rot.shape[0]):
        raise AssertionError("stretch room: a partial plan on one card")
    phase_routing("stretch", _routing_inputs(
        dev, xyz_d, rgb_d, mask_d, hl._order_bounds(xyz, 0.05), grids.trans,
        grids.n_trans, grids.rot, img_init, img_main, rgb_d, False, plan),
        dev)
    del plan, cache
    torch.cuda.empty_cache()


# phase 36: the synthetic accuracy evaluation at reduced depth (3 rooms x 2
# queries an arm); both arms localize every query in the JAX package's
# records (README, docs/ROUND3.md)
EVAL_DEPTH = ["--rooms", "3", "--queries", "2"]
EVAL_ARMS = (
    ("eval_auto", "Stanford profile, splat oracle, descent_table auto",
     ["--descent-table", "auto"]),
    ("eval_sharpen", "Stanford profile, ray-cast oracle, sharpen",
     ["--oracle", "raycast", "--sharpen"]),
)


def _eval_f32_row(name, path, plan, img, rgb, launches, n_q):
    """A kernels row of the f32 group sums at the evaluation's shapes: every
    group of a room's plan against the plain version with a query's init
    image (and, when the query re-bakes, its colours fused), group 0
    timed."""
    from piccolo_tpu_torch.kernels import slab_sampling as slab

    table = slab.slab_table(img, wrap=plan.wrap, window=plan.window)
    rgb4 = None if rgb is None else slab._rgb4(rgb)
    err = 0.0
    for g, (f, w) in enumerate(zip(plan.fields, plan.windows)):
        got = slab.slab_group_sums_f32(table, f, w, plan.window, rgb4)
        want = slab.slab_group_sums_f32_plain(table, f, w, plan.window, rgb4)
        torch.cuda.synchronize()
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"{name}: f32 slab counts differ from the "
                                 f"plain version in group {g}")
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        err = max(err, float((got[0] - want[0]).abs().max()))
    f, w = plan.fields[0], plan.windows[0]
    samples, pads, _, n_win = _f32_plan_stats(f, w)
    nbytes, _ = _f32_bytes(samples, pads, f.shape[0], n_win, plan.window,
                           0 if rgb is None else rgb.shape[0])
    bound_ms, bound_by = _bound(nbytes, samples * F32_OPS_PER_SAMPLE)
    row = dict(
        name=name, route="cuda",
        source="piccolo_tpu_torch/kernels/csrc/slab_sampling.cu",
        replaces="piccolo_tpu/kernels/slab_sampling.py:677", path=path,
        launches=launches, launches_per_query=launches / n_q,
        max_abs_err=err,
        ms=cuda_ms(lambda: slab.slab_group_sums_f32(table, f, w, plan.window,
                                                    rgb4)),
        plain_ms=cuda_ms(lambda: slab.slab_group_sums_f32_plain(
            table, f, w, plan.window, rgb4)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    log(f"{name}: all {len(plan.fields)} groups of room 0's plan (window "
        f"{plan.window}, block {plan.block}, re-bake "
        f"{'fused' if rgb is not None else 'off'}) counts exact, max |sum "
        f"err| {err:.3g}; group 0 {row['ms']:.4f} ms (plain "
        f"{row['plain_ms']:.4f}, bound {bound_ms:.4f} by {bound_by})")
    return row


def phase_eval_synth(dev):
    """python -m piccolo_tpu_torch.eval_synth's main at reduced depth, each
    arm with the wrapper counts set to 0 just before it and read just
    after: Stanford accuracy 1.0, one f32 slab launch a plan group a query
    and one stage-2 count a query (a block histogram of a HistPlan's
    planes, or the live splat's kernel pair under sharpen_color), no
    compact or q8 launch (a room that fell back to the gather engine or a
    compact plan fails); then the kernels held against their plain versions
    at the arm's shapes (room 0's plan and first query, the first stage-2
    call)."""
    from piccolo_tpu_torch import eval_synth

    real_run = eval_synth.run_query
    rows = []
    for key, label, argv in EVAL_ARMS:
        # a query: its room's f32 plan groups (None: gather engine or a
        # compact plan); the first query and its room
        groups, first = [], {}

        def run_query(args, room, q, dev_):
            plan = room.plan
            groups.append(None if plan is None or plan.compact
                          else len(plan.fields))
            first.setdefault("room", room)
            first.setdefault("q", q)
            return real_run(args, room, q, dev_)

        stage2, splats = {}, {}
        out = io.StringIO()
        eval_synth.run_query = run_query
        try:
            _zero_counts()
            with (_recording_stage2(stage2, splats),
                  contextlib.redirect_stdout(out)):
                summary = eval_synth.main(EVAL_DEPTH + argv)
            counts = {k: v["total"] for k, v in _read_counts().items()}
        finally:
            eval_synth.run_query = real_run
        for line in out.getvalue().splitlines():
            log(f"eval_synth {key}: {line}")
        log(f"eval_synth {key} ({label}) summary: {json.dumps(summary)}; "
            f"launches {counts}")
        n_q = len(groups)
        if summary["queries"] != n_q or n_q != 6:
            raise AssertionError(f"{key}: {summary['queries']} queries "
                                 f"scored, {n_q} run")
        if not (math.isfinite(summary["median_t_err_m"])
                and summary["stanford_accuracy"] == 1.0):
            raise AssertionError(f"{key}: Stanford accuracy "
                                 f"{summary['stanford_accuracy']} (the JAX "
                                 "package's record is 1.0)")
        if None in groups:
            raise AssertionError(f"{key}: a query ran without an f32 slab "
                                 f"plan (groups a query: {groups})")
        want = dict(slab_group_sums_f32=sum(groups), stage2=n_q,
                    slab_group_sums_compact=0, slab_group_sums_q8=0)
        got = dict(counts, stage2=_stage2_calls(counts))
        got = {k: got[k] for k in want}
        if got != want:
            raise AssertionError(f"{key}: launches {got}, expected {want}")
        room, q = first["room"], first["q"]
        path = f"eval_synth {label}, 3 rooms x 2 queries"
        rows.append(_eval_f32_row(
            f"slab_group_sums_f32.{key}", path, room.plan, q.img_init,
            q.rgb_used if q.refresh else None, got["slab_group_sums_f32"],
            n_q))
        rows += _stage2_rows(key, path, stage2, splats, counts, n_q)
        del first, room, q, stage2, splats
        torch.cuda.empty_cache()
    return rows


# ---- the measurement scripts (phases 37-40): scripts/*_cuda.py's mains at
# reduced depth, each mode with the wrapper counts set to 0 just before it
# and read just after

TRACK_SCRIPT_ARGS = ["--frames", "20", "--teleport"]  # 1024x512, 60k points
TRACK_SCRIPT_T_ERR_MM = 10.0
SERVING_SUSTAINED = 10
SERVING_DRIFT = 1.5  # last5 median against first5
# track-streams' median t_err over its 2 x 4 tracked frames, run twice.
# With descent_table=float32, the JAX package's table at 1024x512: 7.3 mm
# in three runs on an H100 (700 W), 9.0 mm for the port and 8.4 mm for the
# JAX package on the CPU (one ulp of a warm start moves a tracked pose by
# up to 6.2 mm in the port and 2.4 mm in the JAX package, so each stream
# follows its own path; ROADMAP Queue 3).  With the port's default,
# descent_table=auto, the card takes bf16 texels from 6 MB on
# (ops.sampling.AUTO_BF16_TABLE_BYTES_CARD) where the JAX package keeps
# f32 up to 64 MB: 13.0 mm in the same three runs, the bf16 table's cost
TRACK_STREAMS_T_ERR_M = {"float32": 0.01, "auto": 0.02}
# enough queries for the background build (a 4 GB f32 plan) to land before
# the last: since the splat pair a query takes ~0.17 s, not ~0.5 s
LIFECYCLE_QUERIES = 10
LIFECYCLE_ARGS = ["--points", "60000", "--height", "512", "--queries",
                  str(LIFECYCLE_QUERIES)]
SHARDED_ARGS = ["--points", "60000", "--height", "512"]


def _measure_script(name):
    """A measurement script of ``scripts/`` as a module (its ``main`` and
    mode functions)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"measure_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _recording_stage1(calls):
    """Stage 1's slab scores as the pipeline calls them, the first call's
    init image, plan and re-bake colours kept: the kernel's wrapper still
    runs and counts."""
    from piccolo_tpu_torch import pipeline

    real = pipeline.slab_pair_scores

    def recorded(img, plan, rgb=None):
        if not calls:
            calls.append((img.clone(), plan,
                          None if rgb is None else rgb.clone()))
        return real(img, plan, rgb)

    pipeline.slab_pair_scores = recorded
    try:
        yield
    finally:
        pipeline.slab_pair_scores = real


def _counted(fn, *args, **kw):
    """``fn``'s result, its printed lines and the kernels it launched (the
    counts set to 0 just before it and read just after)."""
    out = io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    counts = {k: v["total"] for k, v in _read_counts().items()}
    return res, out.getvalue().splitlines(), counts


def _expect_launches(label, counts, want):
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def phase_tracking_script(dev):
    """scripts/measure_tracking_cuda.py's main at 20 frames with the
    teleport at frame 10 (1024x512, 60,000 points): recovery at frame 10
    and nowhere else, median t_err under 10 mm, no descent graph captured
    or recaptured after frame 2, and one stage-2 count a full query (the
    seed and the recovery: a block histogram of a HistPlan's planes or the
    live splat's kernel pair; a tracked frame launches none); the kernel
    then held against its plain version on the seed's stage-2 call."""
    from piccolo_tpu_torch import solver

    mod = _measure_script("measure_tracking_cuda")
    recaptures = solver.graph_stats()["recaptures"]
    stage2, splats = {}, {}
    with _recording_stage2(stage2, splats):
        summary, lines, counts = _counted(mod.main, TRACK_SCRIPT_ARGS)
    for ln in lines:
        log(f"tracking script: {ln}")
    graphs = json.loads(next(ln for ln in lines if ln.startswith("graphs: "))
                        [len("graphs: "):])
    if summary["recovered_at"] != [10] or summary["n_recoveries"] != 1:
        raise AssertionError(f"tracking script recovered at "
                             f"{summary['recovered_at']}, not [10]")
    if not summary["median_t_err_mm"] < TRACK_SCRIPT_T_ERR_MM:
        raise AssertionError(f"tracking script median t_err "
                             f"{summary['median_t_err_mm']:.2f} mm")
    if (graphs["captures"] != graphs["captures_by_frame_2"]
            or solver.graph_stats()["recaptures"] != recaptures):
        raise AssertionError(f"tracking script: a descent graph was "
                             f"captured after frame 2: {graphs}")
    n_full = len(summary["full_pipeline_s"])
    _expect_launches("tracking script", dict(
        counts, stage2=_stage2_calls(counts)), dict(
        stage2=n_full, slab_group_sums_f32=0,
        slab_group_sums_compact=0, slab_group_sums_q8=0,
        masked_histogram_counts=0))
    return _stage2_rows(
        "tracking_script", f"measure_tracking_cuda "
        f"{' '.join(TRACK_SCRIPT_ARGS)}: seed and recovery queries", stage2,
        splats, counts, n_full)


def phase_serving_script(dev, tmp):
    """scripts/measure_serving_cuda.py's in-process modes on the card, its
    executable cache in a directory of the run: sustained at 10 queries
    (last5 median <= 1.5x first5; one f32 slab launch a plan group and one
    stage-2 count a query, the warm query included: a block histogram of a
    HistPlan's planes or the live splat's kernel pair), room-auto with the
    probe off over the four rooms x 3 queries (12/12, each room's route
    printed), track-streams at 2 streams x 4 frames with track_batch,
    under descent_table float32 and the default auto (median t_err under
    TRACK_STREAMS_T_ERR_M; the tracked frames launch no kernel); both
    kernels then held against their plain versions on sustained's first
    stage-1 and stage-2 calls."""
    from piccolo_tpu_torch.kernels import _build

    store = _build.library_store()
    env = os.environ.get("PICCOLO_EXEC_CACHE")
    os.environ["PICCOLO_EXEC_CACHE"] = os.path.join(tmp, "serving_exec")
    try:
        mod = _measure_script("measure_serving_cuda")  # reads it at load
    finally:
        if env is None:
            del os.environ["PICCOLO_EXEC_CACHE"]
        else:
            os.environ["PICCOLO_EXEC_CACHE"] = env
    stage1, stage2, splats = [], {}, {}
    try:
        with _recording_stage1(stage1), _recording_stage2(stage2, splats):
            sus, lines, counts = _counted(mod.mode_sustained,
                                          SERVING_SUSTAINED, dev)
        for ln in lines:
            log(f"serving script sustained: {ln}")
        if not sus["last5_median_s"] <= SERVING_DRIFT * sus["first5_median_s"]:
            raise AssertionError(f"serving script sustained drifted: {sus}")
        n_q = SERVING_SUSTAINED + 1  # and the warm query at load
        if (_stage2_calls(counts) != n_q
                or counts["slab_group_sums_f32"] == 0
                or counts["slab_group_sums_f32"] % n_q
                or counts["slab_group_sums_compact"]
                or counts["slab_group_sums_q8"]):
            raise AssertionError(f"serving script sustained: launches "
                                 f"{counts} over {n_q} queries")
        sus_counts = counts
        auto, lines, counts = _counted(mod.mode_room_auto, dev, probe=False)
        for ln in lines:
            log(f"serving script room-auto: {ln}")
        if (auto["correct"], auto["total"]) != (12, 12):
            raise AssertionError(f"serving script room-auto: "
                                 f"{auto['correct']}/{auto['total']}")
        if not (_stage2_calls(counts) > 0
                and counts["slab_group_sums_f32"] > 0):
            raise AssertionError(f"serving script room-auto: launches "
                                 f"{counts}")
        for table, bound in TRACK_STREAMS_T_ERR_M.items():
            mod._CFG["descent_table"] = table
            streams, lines, counts = _counted(
                mod.mode_track_streams, 2, 4, True, 60000, 512, dev)
            label = f"serving script track-streams, descent_table {table}"
            for ln in lines:
                log(f"{label}: {ln}")
            if not streams["median_t_err_m"] < bound:
                raise AssertionError(f"{label}: {streams}")
            # the warm query and the streams' two seeds: full queries; the
            # tracked frames launch none
            _expect_launches(label, dict(
                counts, stage2=_stage2_calls(counts)), dict(
                stage2=3, masked_histogram_counts=0))
    finally:
        mod._CFG.pop("descent_table", None)
        _build.use_store(store)
    img, plan, rgb = stage1[0]
    path = (f"measure_serving_cuda --mode sustained --queries "
            f"{SERVING_SUSTAINED}")
    rows = [_eval_f32_row("slab_group_sums_f32.serving_script", path, plan,
                          img, rgb, sus_counts["slab_group_sums_f32"],
                          SERVING_SUSTAINED + 1)]
    rows += _stage2_rows("serving_script", path, stage2, splats, sus_counts,
                         SERVING_SUSTAINED + 1)
    return rows


def phase_plan_lifecycle_script(dev, tmp):
    """scripts/measure_plan_lifecycle_cuda.py's main at 60,000 points,
    1024x512, LIFECYCLE_QUERIES queries: --sync (the f32 plan resident from q0, one f32
    slab launch a plan group a query) and the background default (the plan
    resident by the last query, the f32 kernel launched on the queries
    after it); the f32 kernel then held against its plain version on the
    --sync run's first stage-1 call."""
    mod = _measure_script("measure_plan_lifecycle_cuda")
    stage1, runs = [], {}
    for label, extra in (("sync", ["--sync"]), ("background", [])):
        argv = ["--cache-dir", os.path.join(tmp, f"plans_{label}")]
        calls = stage1 if label == "sync" else []
        with _recording_stage1(calls):
            out, lines, counts = _counted(mod.main,
                                          argv + LIFECYCLE_ARGS + extra)
        for ln in lines:
            log(f"plan lifecycle script {label}: {ln}")
        log(f"plan lifecycle script {label}: launches {counts}")
        resident = out["plan_resident_after_query"]
        groups = len(calls[0][1].fields) if calls else 0
        on_plan = sum(r.startswith("stage 1 f32 slab plan")
                      for r in out["routes"])
        if label == "sync" and resident != [True] * LIFECYCLE_QUERIES:
            raise AssertionError(f"--sync: plan resident {resident}")
        if not resident[-1]:
            raise AssertionError(f"{label}: no plan by the last query")
        if not (on_plan and counts["slab_group_sums_f32"] > 0
                and counts["slab_group_sums_compact"] == 0
                and counts["slab_group_sums_q8"] == 0
                and (label != "sync"
                     or counts["slab_group_sums_f32"]
                    == LIFECYCLE_QUERIES * groups)):
            raise AssertionError(f"{label}: launches {counts}, routes "
                                 f"{out['routes']}")
        runs[label] = (out, counts)
    img, plan, rgb = stage1[0]
    out, counts = runs["sync"]
    return [_eval_f32_row(
        "slab_group_sums_f32.plan_lifecycle",
        f"measure_plan_lifecycle_cuda --sync {' '.join(LIFECYCLE_ARGS)}",
        plan, img, rgb, counts["slab_group_sums_f32"], LIFECYCLE_QUERIES)]


_SHARDED_WORKER = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("script", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
from piccolo_tpu_torch.kernels import slab_sampling as slab
from piccolo_tpu_torch.kernels.block_histogram import block_histogram
from piccolo_tpu_torch.kernels.histogram import masked_histogram_counts
m.main(sys.argv[2:])
fns = (slab.slab_group_sums_f32, slab.slab_group_sums_compact,
       slab.slab_group_sums_q8, block_histogram, masked_histogram_counts)
print("launches: " + json.dumps({f.__name__: f.launches for f in fns}))
"""


def phase_sharded_restart_script(dev, tmp):
    """scripts/measure_sharded_coldstart_cuda.py twice, two fresh processes
    on one executable-cache directory (60,000 points, 1024x512, the 1 x 1
    mesh of one card): restart false, then true; every library of the
    second a hit, none built; equal t_err; in each, one block histogram a
    query (the mesh's stage 1 here is the gather engine), counted in the
    process."""
    exec_dir = os.path.join(tmp, "sharded_exec")
    runs = []
    for i in range(2):
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-c", _SHARDED_WORKER,
             os.path.join(ROOT, "scripts",
                          "measure_sharded_coldstart_cuda.py"),
             "--exec-cache", exec_dir] + SHARDED_ARGS,
            capture_output=True, text=True, timeout=300, env=_child_env(),
            cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], flush=True)
            raise AssertionError(f"sharded restart process {i} exited "
                                 f"{proc.returncode}")
        lines = proc.stdout.strip().splitlines()
        counts = json.loads(lines[-1][len("launches: "):])
        out = json.loads(lines[-2])
        log(f"sharded restart process {i}: {json.dumps(out)}; launches "
            f"{counts}; wall {time.time() - t0:.2f} s")
        _expect_launches(f"sharded restart process {i}", counts, dict(
            block_histogram=2, slab_group_sums_f32=0,
            slab_group_sums_compact=0, slab_group_sums_q8=0))
        runs.append(out)
    first, second = runs
    n_libs = 6 if dev.type == "cuda" else 1
    if (first["restart"], second["restart"]) != (False, True):
        raise AssertionError(f"sharded restart: restart "
                             f"{first['restart']}, {second['restart']}")
    if len(first["built"]) != n_libs or first["hits"]:
        raise AssertionError(f"sharded restart: the first process found "
                             f"{first['hits']}, built {first['built']}")
    if not second["loaded"] or second["built"] or len(second["hits"]) != n_libs:
        raise AssertionError(f"sharded restart: the second process found "
                             f"{second['hits']}, built {second['built']}")
    if first["t_err_m"] != second["t_err_m"]:
        raise AssertionError(f"sharded restart: t_err {first['t_err_m']} "
                             f"then {second['t_err_m']}")


def timed(name, fn, *args):
    t0 = time.time()
    out = fn(*args)
    log(f"phase {name}: {time.time() - t0:.2f} s")
    note_graphs()
    return out


def main():
    timed("device", phase_device)
    dev = torch.device("cuda", 0)
    timed("build", phase_build)
    room = timed("room", phase_room, dev)
    rows = timed("kernels", phase_kernels, room, dev)
    timed("small reference", phase_small_reference, dev)
    _, median_s, lib_bh = timed("main path", phase_main_path, room, dev)
    rows.append(lib_bh)
    timed("routing library", phase_routing_library, room, dev)
    timed("profile", phase_profile, room, dev, median_s)
    timed("graph vs eager", phase_graph_vs_eager, room, dev)
    rows += timed("descent step", phase_descent_step, room, dev)
    timed("speed modes", phase_speed_modes, room, dev)
    mesh = timed("mesh", phase_mesh, room, dev)
    del room
    torch.cuda.empty_cache()
    # first of the CLI-scale phases: the stretch plan needs the card's
    # memory as a fresh process has it
    timed("routing stretch", phase_routing_stretch, dev)
    tmp = tempfile.mkdtemp(prefix="piccolo_cli_")
    try:
        cli = timed("cli room", phase_cli_room, dev, tmp)
        rows += timed("layout kernels", phase_layout_kernels, cli, dev)
        timed("routing stanford.ini", phase_routing_cli, cli, dev)
        torch.cuda.empty_cache()
        launched = timed("cli", phase_cli, cli, dev)
        timed("cli profile_dir", phase_cli_profile, cli, dev)
        cli_tree = cli["tree"]
        timed("cli stanford_parallel", phase_cli_parallel, cli_tree, dev)
        if torch.cuda.device_count() >= 2:
            timed("mesh cli and serving", phase_mesh_cli_serving, cli_tree,
                  dev)
        else:
            log("mesh cli and serving: needs two cards (1 visible), not run")
        del cli
        torch.cuda.empty_cache()
        one_process = timed("exec cache", phase_exec_cache, cli_tree, dev)
        timed("init_distributed", phase_distributed, cli_tree, one_process,
              dev)
        timed("visualize gif", phase_gif, cli_tree, dev)
        timed("serving", phase_serving, dev, tmp, cli_tree)
        omni = timed("omniscenes tree", phase_omni_tree, tmp)
        o = timed("omniscenes room", phase_omni_room, dev, omni)
        omni_rows = timed("omniscenes kernels", phase_omni_kernels, o, dev)
        timed("routing omniscenes.ini", phase_routing_omni, o, dev)
        runs = timed("omniscenes cli", phase_omni_cli, omni, dev,
                     o["layout"])
        timed("omniscenes profile", phase_omni_profile, o, dev,
              runs["fused"]["s"])
        track_rows = timed("omniscenes colour", phase_omni_colour, o, dev)
        tracking = timed("omniscenes tracking", phase_omni_tracking, omni,
                         dev, runs["fused"])
        timed("omniscenes cli profile_dir", phase_omni_cli_profile, omni,
              dev)
        timed("tracked frame profile", phase_omni_track_profile, o, dev,
              tracking["tracking"]["tracked_s"])
        timed("omniscenes batched tracking", phase_omni_batch, o, omni, dev)
        del o
        torch.cuda.empty_cache()
        rows += timed("eval_synth", phase_eval_synth, dev)
        rows += timed("tracking script", phase_tracking_script, dev)
        rows += timed("serving script", phase_serving_script, dev, tmp)
        rows += timed("plan lifecycle script", phase_plan_lifecycle_script,
                      dev, tmp)
        timed("sharded restart script", phase_sharded_restart_script, dev,
              tmp)
        fused = runs["fused"]["launches"]
        for row in omni_rows:
            kernel = row["name"].split(".")[0]
            row["launches"] = fused[kernel]
            row["launches_per_query"] = fused[kernel] / OMNI_QUERIES
            row["path"] = "omniscenes cli fused"
        # the tracked frames' colour prep, at the shapes these rows time:
        # block_histogram in color_match_device, masked_histogram_counts in
        # color_mod_device (sharpen_color); the seed frame's stage 2 is
        # not counted here
        for row in track_rows:
            kernel = row["name"].split(".")[0]
            run = ("tracking" if kernel == "block_histogram"
                   else "tracking, sharpen_color")
            row["launches"] = tracking[run]["colour"][kernel]
            row["launches_per_query"] = row["launches"] / (OMNI_QUERIES - 1)
            row["path"] = (f"omniscenes cli {run}, tracked frames' colour "
                           "prep")
        rows += omni_rows + track_rows
        n = tracking["tracking, sharpen_color"]["colour"][
            "masked_histogram_counts"]
        launched["masked_histogram_counts"] = (
            n, OMNI_QUERIES - 1, "omniscenes cli tracking, sharpen_color, "
            "tracked frames' colour prep")
        torch.cuda.empty_cache()
        if torch.cuda.device_count() >= 2:
            timed("mesh stretch room", phase_mesh_stretch, dev)
        else:
            log("mesh stretch room: needs two cards (1 visible), not run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for row in rows:
        if "path" in row:
            continue
        # launches: the CLI run that drives the kernel
        n, n_q, run = launched.get(row["name"], (0, None, None))
        row["launches"] = n
        row["launches_per_query"] = None if n_q is None else n / n_q
        row["path"] = ("no query path" if run is None else run
                       if run.startswith("omniscenes") else f"cli run {run}")
    log("routing: " + json.dumps(ROUTING))
    log("profiles: " + json.dumps(PROFILES))
    from piccolo_tpu_torch import solver

    counts = {k: v for k, v in solver.graph_stats().items() if k != "graphs"}
    log("graphs: " + json.dumps(dict(counts, graphs=[GRAPHS[k]
                                                     for k in sorted(GRAPHS)])))
    # the mesh path's rows (phase 24) carry their launches and errors by card
    rows += mesh["rows"]
    keys = ("name", "route", "source", "replaces", "path", "launches",
            "launches_per_query", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # optional: by card on the mesh's rows, the CTA threads and an empty
    # launch's ms on the block histogram's, the autograd step's graph and
    # a query's replays on the descent step's
    by_card = ("launches_by_card", "max_abs_err_by_card", "threads",
               "empty_launch_ms", "autograd_graph_ms", "replays_per_query")
    print(json.dumps({"kernels": [
        {k: row[k] for k in keys + by_card if k in keys or k in row}
        for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
