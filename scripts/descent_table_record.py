#!/usr/bin/env python3
"""Record which start the descent picks with a bf16 and an f32 table, in
both packages, on the CPU.

    JAX_PLATFORMS=cpu python scripts/descent_table_record.py [--frames 1]
        [--out FILE]

Writes ``chip_smoke.py``'s OmniScenes tree (``write_synth_omniscenes``:
one ray-cast room, one video of 4 frames, 60,000 points, 2048x1024 JPEG
q95, seed 7) and runs its first ``--frames`` frames through the fused query
of each package under the shipped ``configs/omniscenes.ini`` (its colour
prep, grids and budget; stage 1 on the gather engine, as ``auto`` plans are
off on the CPU), once with ``descent_table = auto`` (bf16 at 2048x1024) and
once with ``float32``. One JSON line per (package, frame, table): the
winner's index, its pose and loss, every start's final loss and the
winner's t_err. ``--out`` also writes all lines to a file. A query takes a
few minutes on the CPU in each package.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TABLES = ("auto", "float32")


def _jax_runner(cfg, pcd):
    from piccolo_tpu.config import apply_overrides
    from piccolo_tpu.data import read_omniscenes
    from piccolo_tpu.harness import localize as hl

    init = hl.get_init_dict(cfg)
    xyz, rgb = (a.astype(np.float32) for a in read_omniscenes(pcd, 1))
    xyz_d, rgb_d, mask_d = hl._pad_cloud(xyz, rgb)
    lo, hi = hl._order_bounds(xyz, 0.05)
    room = dict(xyz=xyz_d, rgb=rgb_d, mask=mask_d, rgb_np=rgb, lo=lo, hi=hi)
    grids = hl._FusedGrids(xyz, init)

    def run(raw, table):
        _, ii, im, ru, _ = hl.prepare_omniscenes_images(cfg, raw, room)
        c = apply_overrides(cfg, f"descent_table={table}")
        res = hl._run_fused(ii, im, room, ru, c, init, grids)
        return {k: np.asarray(getattr(res, k)) for k in
                ("winner", "t", "loss", "cand_loss", "start_t")}

    return run


def _port_runner(cfg, pcd):
    import torch

    from piccolo_tpu_torch.config import apply_overrides
    from piccolo_tpu_torch.data import read_omniscenes
    from piccolo_tpu_torch.harness import localize as hl

    init = hl.get_init_dict(cfg)
    room = hl._load_room(read_omniscenes, pcd, 1, 0.05,
                         torch.device("cpu"), init)

    def run(raw, table):
        _, ii, im, ru, _ = hl.prepare_omniscenes_images(cfg, raw, room)
        c = apply_overrides(cfg, f"descent_table={table}")
        res, _ = hl._run_fused(ii, im, room, ru, c, init, room["grids"])
        return {k: getattr(res, k).numpy() for k in
                ("winner", "t", "loss", "cand_loss", "start_t")}

    return run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from piccolo_tpu.config import apply_overrides as japply
    from piccolo_tpu.config import parse_ini as jparse
    from piccolo_tpu_torch.config import apply_overrides, parse_ini
    from piccolo_tpu_torch.data import obtain_gt_omniscenes, omniscenes_pano_glob
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.testing import write_synth_omniscenes

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    config = os.path.join(ROOT, "configs", "omniscenes.ini")
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        tree = os.path.join(tmp, "omni")
        write_synth_omniscenes(tree, rooms=1, queries=4, points=60000,
                               height=1024, seed=7, oracle="raycast")
        pcd = glob.glob(os.path.join(tree, "omniscenes", "pcd", "*.txt"))[0]
        panos = sorted(glob.glob(omniscenes_pano_glob(tree)))[:args.frames]
        ov = f"data_root={tree}"
        runners = {"jax": _jax_runner(japply(jparse(config), ov), pcd),
                   "port": _port_runner(apply_overrides(parse_ini(config),
                                                        ov), pcd)}
        for i, p in enumerate(panos):
            raw = imread_rgb(p)
            gt_t, _ = obtain_gt_omniscenes(p)
            for pkg, run in runners.items():
                for table in TABLES:
                    t0 = time.time()
                    r = run(raw, table)
                    line = dict(
                        package=pkg, frame=i, table=table,
                        winner=int(r["winner"]),
                        t=[float(v) for v in np.ravel(r["t"])],
                        loss=float(r["loss"]),
                        cand_loss=[float(v) for v in np.ravel(r["cand_loss"])],
                        starts=np.asarray(r["start_t"]).round(4).tolist(),
                        t_err=float(np.linalg.norm(np.ravel(r["t"])
                                                   - np.ravel(gt_t))),
                        seconds=time.time() - t0)
                    print(json.dumps(line), flush=True)
                    lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)


if __name__ == "__main__":
    main()
