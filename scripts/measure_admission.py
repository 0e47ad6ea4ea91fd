#!/usr/bin/env python3
"""Time both sides of each stage-1 routing decision on one NVIDIA GPU.

    python3 scripts/measure_admission.py [--parts chunk,slab,memory,table]
        [--out chiprun_out/measure_admission.json]

The port chooses how the card runs a query by five values:

  * ``grid_chunk`` (``pipeline.localize_query``): the poses the gather
    engine scores together, so the number of its launches;
  * ``slab_worthwhile`` (``kernels/slab_sampling.py``): a plan and the slab
    kernel, or the gather engine, for stage 1;
  * ``_PLAN_MEM_FRACTION`` (``default_plan_bytes_cap``): the plan budget's
    share of the card, which walks the ladder f32 -> compact -> q8 ->
    partial q8 -> gather engine;
  * ``resolve_plan_geometry``: the slab kernel's (window, block);
  * ``AUTO_BF16_TABLE_BYTES`` (``ops/sampling.py``): the descent table's
    dtype under ``descent_table = auto``.

Parts (``--parts``, default all), each at the shapes the repo runs: the
library room (60,000 points, 1024x512 main, 512x256 init, 50 trans x 8
yaws), configs/stanford.ini on a ray-cast tree as chip_smoke.py writes it
(runs A and D: 1024x512 panoramas, init at full size), configs/omniscenes.ini
on a ray-cast tree (2048x1024 frames), the 1.02 M-point stretch room
(4096x2048 main, 1024x512 init, 50 trans x 8 yaws) and a sweep of the
library room's init image over tables of ~6, 25, 101 and 403 MB:

  chunk   the gather engine's wall time (host clock around a synchronised
          call; launches dominate it) at grid_chunk 16, 32, 64, 128 and
          256, in turns, with the peak memory it adds and whether its
          scores equal chunk 16's bit for bit;
  slab    every layout (f32, compact, q8), with and without the re-bake
          that sharpen_color forces, under both geometries ((128, 1024) and
          (256, 512)): device ms a group (CUDA events, a sleep kernel
          queued first) and the wall time of slab_pair_scores a group and
          per query, beside the gather engine's wall time at the same pairs
          (from ``chunk``) and the plan's build time;
  memory  with sharpen_color on, at each shipped config's largest shape and
          the stretch room: an f32 plan built in line, the peak allocated
          during its build and during two queries that re-bake it, and so
          the peak outside the plan;
  table   a graphed 6-start x 100-step descent on f32 and on bf16 tables at
          512x256, 1024x512, 2048x1024 and 4096x2048 (library room, 8
          poses), and on the stretch room at 4096x2048 (3 poses): wall ms a
          step in turns at the first pose, and each winner's t_err;
  points  the gather engine at the card's default chunk
          (``init.refine.gather_chunk``) against chunk 16 on clouds of
          4,096 to 1,048,576 points: bit-equal scores, and wall time.

Prints the card's name and power limit, then one JSON line per decision and
shape; writes all of them to ``--out``.  Needs a card: without one it exits
1.  About 3 minutes on an H100.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CHUNKS = (16, 32, 64, 128, 256)
GEOMETRIES = ((128, 1024), (256, 512))
SWEEP_HW = ((512, 1024), (1024, 2048), (2048, 4096))  # beside the library's
SWEEP_PAIRS = (128, 1152, 4096, 20000)
GATHER_PAIRS = 1024  # pairs the gather engine scores per timing
PARTS = ("chunk", "slab", "memory", "table", "points")
OUT = []


def emit(rec):
    OUT.append(rec)
    print(json.dumps(rec), flush=True)


def wall_s(fn, reps=3):
    """Median host seconds of a synchronised call, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def table_mb(h, w):
    return (h + 1) * (w + 1) * 48 / 1e6


# ---------------------------------------------------------------------------
# shapes


def _grid_room(name, n_per_wall, init_hw, main_hw, dev, seed=7):
    """A make_room box room (the library's and the stretch room's) with the
    bench's grids (50 trans x 8 yaws) and images rendered at one pose."""
    from piccolo_tpu_torch.harness import localize as hl
    from piccolo_tpu_torch.init.candidates import default_init_dict
    from piccolo_tpu_torch.testing import make_room, random_pose_inside
    from piccolo_tpu_torch.testing import render_at

    rng = np.random.default_rng(seed)
    xyz, rgb = make_room(rng, n_per_wall=n_per_wall, size=cs.SIZE,
                         texture="checker")
    xyz_d, rgb_d, mask_d = hl._pad_cloud(xyz, rgb, dev)
    lo, hi = hl._order_bounds(xyz, 0.05)
    init = default_init_dict(xy_only=True, yaw_only=True, num_yaw=8,
                             num_split_h=4, num_split_w=4, num_trans=50,
                             z_prior=None)
    grids = hl._FusedGrids(xyz, init, dev)
    gt_t, gt_ypr = random_pose_inside(np.random.default_rng(seed + 1),
                                      cs.SIZE)
    img_main = render_at(xyz, rgb, gt_t, gt_ypr, main_hw, device=dev)
    sh, sw = main_hw[0] // init_hw[0], main_hw[1] // init_hw[1]
    return dict(name=name, xyz=xyz, rgb=rgb, xyz_d=xyz_d, rgb_d=rgb_d,
                rgb_used=rgb_d, mask_d=mask_d, lo=lo, hi=hi, grids=grids,
                img_init=img_main[::sh, ::sw].contiguous(),
                img_main=img_main, gt_t=gt_t, gt_ypr=gt_ypr, cfg=None)


def _stanford_room(tmp, dev):
    """configs/stanford.ini on chip_smoke.py's ray-cast tree: the CLI's
    cloud, grids and first query's images (sharpen_color on)."""
    from piccolo_tpu_torch.config import apply_overrides, cfg_get, parse_ini
    from piccolo_tpu_torch.data import read_stanford
    from piccolo_tpu_torch.harness import localize as hl
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.testing import write_synth_stanford

    tree = os.path.join(tmp, "stanford_tree")
    write_synth_stanford(tree, rooms=1, queries=1, points=60000, height=512,
                         seed=7, oracle="raycast")
    cfg = apply_overrides(parse_ini(cs.CONFIG), f"data_root={tree}")
    hl._seed_everything()
    pcd = os.path.join(tree, "stanford", "pcd_not_aligned", "area_1",
                       "office_1.txt")
    room = hl._load_room(read_stanford, pcd, cfg_get(cfg, "sample_rate", 1),
                         0.05, dev, hl.get_init_dict(cfg))
    pano = sorted(glob.glob(os.path.join(tree, "stanford", "pano", "area_1",
                                         "*.png")))[0]
    img_init, img_main, rgb_used, _ = hl.prepare_stanford_images(
        cfg, imread_rgb(pano), room)
    return _loaded("stanford.ini", cfg, room, img_init, img_main, rgb_used)


def _omni_room(tmp, dev):
    """configs/omniscenes.ini on a ray-cast OmniScenes tree (60,000 points,
    2048x1024 JPEG frames), loaded as the CLI loads it."""
    from piccolo_tpu_torch.config import apply_overrides, cfg_get, parse_ini
    from piccolo_tpu_torch.data import omniscenes_pano_glob, read_omniscenes
    from piccolo_tpu_torch.harness import localize as hl
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.testing import write_synth_omniscenes

    tree = os.path.join(tmp, "omni_tree")
    write_synth_omniscenes(tree, rooms=1, queries=1, points=60000,
                           height=1024, seed=7, oracle="raycast")
    cfg = apply_overrides(parse_ini(cs.OMNI_CONFIG), f"data_root={tree}")
    hl._seed_everything()
    pcd = glob.glob(os.path.join(tree, "omniscenes", "pcd", "*.txt"))[0]
    room = hl._load_room(read_omniscenes, pcd, cfg_get(cfg, "sample_rate", 1),
                         0.05, dev, hl.get_init_dict(cfg))
    raw = imread_rgb(sorted(glob.glob(omniscenes_pano_glob(tree)))[0])
    _, img_init, img_main, rgb_used, _ = hl.prepare_omniscenes_images(
        cfg, raw, room)
    return _loaded("omniscenes.ini", cfg, room, img_init, img_main, rgb_used)


def _loaded(name, cfg, room, img_init, img_main, rgb_used):
    dev = room["xyz"].device
    img_init, img_main, rgb_used = (
        torch.as_tensor(np.asarray(a, np.float32) if isinstance(a, np.ndarray)
                        else a, device=dev).float().contiguous()
        for a in (img_init, img_main, rgb_used))
    return dict(name=name, xyz=room["xyz_np"], rgb=room["rgb_np"],
                xyz_d=room["xyz"], rgb_d=room["rgb"], rgb_used=rgb_used,
                mask_d=room["mask"], lo=room["lo"], hi=room["hi"],
                grids=room["grids"], img_init=img_init, img_main=img_main,
                gt_t=None, gt_ypr=None, cfg=cfg)


def shapes(dev, tmp, parts):
    """Every shape a part times, by name, built once."""
    out = [_grid_room("library", 10000, (256, 512), (512, 1024), dev)]
    if {"chunk", "slab", "memory"} & parts:
        out += [_stanford_room(tmp, dev), _omni_room(tmp, dev)]
    if {"chunk", "slab"} & parts:
        for h, w in SWEEP_HW:
            out.append(_grid_room(f"sweep {w}x{h}", 10000, (h, w), (h, w),
                                  dev))
    out.append(_grid_room("stretch", 170000, (512, 1024), (2048, 4096), dev))
    for s in out:
        g = s["grids"]
        s["n_pairs"] = g.n_trans * int(g.rot.shape[0])
        s["points"] = int(s["mask_d"].shape[0])
        s["init_hw"] = tuple(s["img_init"].shape[:2])
        s["table_mb"] = table_mb(*s["init_hw"])
    return out


def _pairs(s, n):
    from piccolo_tpu_torch.kernels.slab_sampling import make_pairs

    g = s["grids"]
    pair_t, pair_r = make_pairs(g.trans[:g.n_trans], g.rot)
    return pair_t[:n], pair_r[:n]


# ---------------------------------------------------------------------------
# grid_chunk: the gather engine


def part_chunk(s):
    from piccolo_tpu_torch.init.refine import _score_pairs

    n = min(s["n_pairs"], GATHER_PAIRS)
    pair_t, pair_r = _pairs(s, n)
    img = s["img_init"]

    def run(c):
        return _score_pairs(img, s["xyz_d"], s["rgb_d"], pair_t, pair_r,
                            s["mask_d"], c)

    ref = run(16)
    res = {}
    for c in CHUNKS:
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = run(c)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            res[c] = dict(bit_equal=bool(torch.equal(got, ref)),
                          max_abs_diff=float((got - ref).abs().max()),
                          peak_bytes=int(peak), wall_s=[])
        except torch.cuda.OutOfMemoryError:
            res[c] = dict(oom=True)
        torch.cuda.empty_cache()
    live = [c for c in CHUNKS if not res[c].get("oom")]
    for order in (live, live[::-1], live, live[::-1]):  # in turns
        for c in order:
            res[c]["wall_s"].append(wall_s(lambda: run(c), reps=1))
    for c in live:
        w = statistics.median(res[c]["wall_s"])
        res[c].update(wall_s_median=w, s_per_pair=w / n)
    emit(dict(decision="grid_chunk", shape=s["name"], points=s["points"],
              init_hw=s["init_hw"], table_mb=s["table_mb"], pairs=n,
              chunks=res))
    return res


# ---------------------------------------------------------------------------
# slab_worthwhile and the geometry: the slab kernels against the gather engine


VARIANTS = (  # (layout, refresh): compact and q8 plans re-bake from pids
    ("f32", False), ("f32", True), ("compact", False), ("compact", True),
    ("q8", False), ("q8", True))


def _build(s, layout, refresh, window, block, groups):
    from piccolo_tpu_torch.kernels.slab_sampling import build_grid_plan

    g = s["grids"]
    H, W = s["init_hw"]
    compact = layout != "f32"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = build_grid_plan(
        s["xyz_d"], s["rgb_d"], s["mask_d"], g.trans[:g.n_trans], g.rot, H,
        W, compact=compact, tp_is_pid=compact and refresh,
        quant=layout == "q8", window=window, block=block, device=s["xyz_d"].device,
        groups=(0, groups))
    torch.cuda.synchronize()
    return plan, time.perf_counter() - t0


def part_slab(s, gather):
    """Every layout, with and without the re-bake, under both geometries;
    then the stage-1 pick at this shape's own pairs and the sweep's."""
    from piccolo_tpu_torch.kernels.slab_sampling import (
        GROUP,
        plan_group_sums,
        resolve_plan_geometry,
        slab_pair_scores,
        slab_table,
    )

    total = -(-s["n_pairs"] // GROUP)
    built = min(total, 2 if s["name"] == "stretch" else 4)
    H, W = s["init_hw"]
    resolved = resolve_plan_geometry(s["points"], H, W)
    img, rgb = s["img_init"], s["rgb_used"]
    rows = []
    for layout, refresh in VARIANTS:
        if s["name"] == "stretch" and layout != "f32" and not refresh:
            continue  # 1 M points: the ladder's re-bake layouts only
        for window, block in GEOMETRIES:
            plan, build_s = _build(s, layout, refresh, window, block, built)
            one = cs._first_groups(plan, 1)
            palette = rgb if refresh else None
            table = slab_table(img, window=window)
            dev_ms = cs.cuda_ms(lambda: plan_group_sums(table, plan, palette),
                                reps=10) / built
            w1 = wall_s(lambda: slab_pair_scores(img, one, palette))
            wg = wall_s(lambda: slab_pair_scores(img, plan, palette))
            per = (wg - w1) / (built - 1) if built > 1 else w1
            rows.append(dict(
                layout=layout, refresh=refresh, window=window, block=block,
                resolved=(window, block) == resolved, groups_built=built,
                plan_bytes=plan.nbytes, build_s=build_s,
                slots_per_group=int(plan.fields[0].shape[0]) * block,
                device_ms_group=dev_ms, wall_s_group=per,
                wall_s_fixed=max(w1 - per, 0.0)))
            del plan, one, table
            torch.cuda.empty_cache()
    for r in rows:
        emit(dict(decision="slab_kernel", shape=s["name"],
                  points=s["points"], init_hw=s["init_hw"],
                  table_mb=s["table_mb"], **r))
    for layout, refresh in VARIANTS:
        geo = {(r["window"], r["block"]): r["device_ms_group"] for r in rows
               if (r["layout"], r["refresh"]) == (layout, refresh)}
        if len(geo) == 2:
            emit(dict(decision="plan_geometry", shape=s["name"],
                      points=s["points"], init_hw=s["init_hw"],
                      density=s["points"] / ((H + 1) * (W + 1)),
                      layout=layout, refresh=refresh,
                      resolved=list(resolved),
                      device_ms_group={f"{w}x{b}": v
                                       for (w, b), v in geo.items()},
                      faster=list(min(geo, key=geo.get))))
    picks = {}
    for n_pairs in sorted({s["n_pairs"], *SWEEP_PAIRS}):
        groups = -(-n_pairs // GROUP)
        slab = {f"{r['layout']}{' re-bake' if r['refresh'] else ''}":
                r["wall_s_fixed"] + groups * r["wall_s_group"]
                for r in rows if (r["window"], r["block"]) == resolved}
        gather_s = {c: n_pairs * v["s_per_pair"] for c, v in gather.items()
                    if "s_per_pair" in v}
        picks[n_pairs] = dict(slab_wall_s=slab, gather_wall_s=gather_s)
    emit(dict(decision="slab_worthwhile", shape=s["name"],
              points=s["points"], init_hw=s["init_hw"],
              table_mb=s["table_mb"], shape_pairs=s["n_pairs"],
              by_pairs=picks))


# ---------------------------------------------------------------------------
# the plan fraction: the peak device memory outside the plan


def part_memory(s):
    """An f32 plan of every group built in line, then two queries that
    re-bake it (sharpen_color's route): the peaks of each."""
    from piccolo_tpu_torch.kernels.slab_sampling import build_grid_plan
    from piccolo_tpu_torch.pipeline import localize_query

    g = s["grids"]
    H, W = s["init_hw"]
    dev = s["xyz_d"].device
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    plan = build_grid_plan(s["xyz_d"], s["rgb_d"], s["mask_d"],
                           g.trans[:g.n_trans], g.rot, H, W, device=dev)
    torch.cuda.synchronize()
    peak_build = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(num_intermediate=20 if s["cfg"] is None else 50, num_input=6,
              num_iter=100, lr=0.1, patience=5, factor=0.8)
    for _ in range(2):
        res = localize_query(s["img_init"], s["img_main"], s["xyz_d"],
                             s["rgb_used"], g.trans, g.rot, g.valid, s["lo"],
                             s["hi"], s["mask_d"], masked=True, plan=plan,
                             plan_refresh_rgb=True, device=dev, **kw)
        res.t.cpu()
    torch.cuda.synchronize()
    peak_query = torch.cuda.max_memory_allocated()
    _, total = torch.cuda.mem_get_info()
    emit(dict(decision="plan_fraction", shape=s["name"], points=s["points"],
              pairs=s["n_pairs"], init_hw=s["init_hw"],
              main_hw=tuple(s["img_main"].shape[:2]), card_bytes=total,
              room_bytes=before, plan_bytes=plan.nbytes,
              peak_build=peak_build, peak_query=peak_query,
              outside_plan_build=peak_build - plan.nbytes,
              outside_plan_query=peak_query - plan.nbytes,
              worst_share=max(peak_build, peak_query) / total))
    del plan
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the descent table's dtype


def part_table(s, main_hw=None, poses=8):
    """The descent from 6 starts around each of ``poses`` poses on the f32
    and the bf16 table: each winner's t_err; the first pose's descent timed
    in turns."""
    from piccolo_tpu_torch.solver import descend_starts
    from piccolo_tpu_torch.testing import random_pose_inside, render_at

    dev = s["xyz_d"].device
    lo, hi = (torch.as_tensor(np.asarray(b, np.float32), device=dev)
              for b in (s["lo"], s["hi"]))
    dtypes = ("float32", "bfloat16")
    t_err = {d: [] for d in dtypes}
    walls = {d: [] for d in dtypes}
    for k in range(poses):
        if k == 0 and main_hw is None:
            gt_t, gt_ypr, img = s["gt_t"], s["gt_ypr"], s["img_main"]
        else:
            gt_t, gt_ypr = (s["gt_t"], s["gt_ypr"]) if k == 0 else \
                random_pose_inside(np.random.default_rng(100 + k), cs.SIZE)
            img = render_at(s["xyz"], s["rgb"], gt_t, gt_ypr,
                            main_hw or tuple(s["img_main"].shape[:2]),
                            device=dev)
        rng = np.random.default_rng(3 + k)
        t0s = torch.as_tensor(
            (gt_t + rng.uniform(-0.15, 0.15, (6, 3))).astype(np.float32),
            device=dev)
        ypr = np.zeros((6, 3), np.float32)
        ypr[:, 0] = gt_ypr[0] + rng.uniform(-0.2, 0.2, 6)
        ypr0s = torch.as_tensor(ypr, device=dev)

        def run(dtype):
            params, losses, _, _ = descend_starts(
                img, s["xyz_d"], s["rgb_d"], t0s, ypr0s, lo, hi,
                s["mask_d"], 100, 0.1, 5, 0.8, table_dtype=dtype)
            w = int(torch.argmin(losses))
            return float(np.linalg.norm(params.t[w].cpu().numpy()
                                        - np.ravel(gt_t)))

        for d in dtypes:
            t_err[d].append(run(d))
        if k == 0:
            for order in (dtypes, dtypes[::-1]) * 3:
                for d in order:
                    walls[d].append(wall_s(lambda: run(d), reps=1))
    H, W = img.shape[:2]
    emit(dict(decision="descent_table", shape=s["name"], points=s["points"],
              main_hw=(H, W), table_mb_f32=table_mb(H, W),
              ms_per_step={d: 1e3 * statistics.median(v) / 100
                           for d, v in walls.items()},
              walls_s=walls, t_err=t_err,
              t_err_median={d: statistics.median(v)
                            for d, v in t_err.items()}))


def part_points(dev):
    """The gather engine at the card's default chunk against chunk 16 over
    cloud buckets from 4,096 to 1,048,576 points: bits and wall time."""
    from piccolo_tpu_torch.init.refine import _score_pairs, gather_chunk

    for n in (4096, 49152, 65536, 98304, 131072, 196608, 1048576):
        s = _grid_room(f"{n} points", n // 6, (512, 1024), (512, 1024), dev)
        pts = int(s["mask_d"].shape[0])
        c = gather_chunk(pts, dev)
        pair_t, pair_r = _pairs(s, 256)

        def run(k):
            return _score_pairs(s["img_init"], s["xyz_d"], s["rgb_d"],
                                pair_t, pair_r, s["mask_d"], k)

        ref, got = run(16), run(c)
        walls = {16: [], c: []}
        for order in ((16, c), (c, 16)) * 2:
            for k in order:
                walls[k].append(wall_s(lambda: run(k), reps=1))
        emit(dict(decision="grid_chunk_rule", points=pts, chunk=c,
                  pairs=256, bit_equal=bool(torch.equal(got, ref)),
                  max_abs_diff=float((got - ref).abs().max()),
                  wall_s={k: statistics.median(v) for k, v in walls.items()}))
        del s
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "measure_admission.json"))
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if parts - set(PARTS):
        ap.error(f"--parts must name some of {PARTS}")
    smi = cs.phase_device()  # exits 1 without a card
    dev = torch.device("cuda", 0)
    t_start = time.time()
    tmp = tempfile.mkdtemp(prefix="measure_admission_")
    all_shapes = shapes(dev, tmp, parts)
    for s in all_shapes:
        print(f"shape {s['name']}: {s['points']} points, {s['n_pairs']} "
              f"pairs, init {s['init_hw']}, table {s['table_mb']:.1f} MB",
              flush=True)
    for s in all_shapes:
        gather = part_chunk(s) if {"chunk", "slab"} & parts else None
        if "slab" in parts:
            part_slab(s, gather)
        if "memory" in parts and s["name"] in ("stanford.ini",
                                               "omniscenes.ini", "stretch"):
            part_memory(s)
        if "table" in parts and s["name"] == "library":
            for hw in ((256, 512), (512, 1024), (1024, 2048), (2048, 4096)):
                part_table(s, hw)
        if "table" in parts and s["name"] == "stretch":
            part_table(s, poses=3)
        torch.cuda.empty_cache()
    if "points" in parts:
        part_points(dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=smi, seconds=time.time() - t_start,
                       records=OUT), f, indent=1)
    print(f"measure_admission: {len(OUT)} records in "
          f"{time.time() - t_start:.1f} s -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
