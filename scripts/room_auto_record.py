#!/usr/bin/env python3
"""Record which room ``room = "auto"`` picks, in both packages, on the CPU.

    python scripts/room_auto_record.py [--queries 1] [--modes False,True]
        [--override KEY=VALUE,...] [--out FILE]

Writes a two-room ray-cast Stanford tree (``write_synth_stanford``, seed 7,
60,000 points a room, 1024x512 panoramas). With ``--queries 1`` its first
room and first panorama are the same files as ``chip_smoke.py``'s CLI room
and first query, and its second room is the second room the serving phase
loads. Both rooms go into the JAX package's ``LocalizeService`` and into the
port's (``device="cpu"``) under ``configs/stanford.ini`` (plus
``--override``), and every query asks ``room = "auto"``: in the default mode
(a full query per room) and with ``room_auto_probe = True`` (a probe per
room first). ``--modes batched --override sharpen_color=False`` records
the one-program probe over both rooms (``probe.probe_rooms``; under colour
prep both packages fall back to the per-room probe). One JSON line per
(package, mode, query): the room picked, the room scores (a full query's
loss, or the probe's for a room the probe ruled out), the order of the
scores and the winner's t_err. ``--out`` also writes all lines to a file.

The JAX package compiles for the CPU here: run it with
``JAX_PLATFORMS=cpu``. A full query at this size takes tens of seconds on
the CPU in each package.
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
CONFIG = os.path.join(ROOT, "configs", "stanford.ini")


def _services(pkg: str, mode: str, override: str):
    """A two-room service of package ``pkg`` ("jax" or "torch")."""
    probe = f"room_auto_probe={mode}"
    extra = f"{override},{probe}" if override else probe
    if pkg == "jax":
        from piccolo_tpu.config import apply_overrides, parse_ini
        from piccolo_tpu.serve import LocalizeService

        return LocalizeService(apply_overrides(parse_ini(CONFIG), extra),
                               max_rooms=2)
    from piccolo_tpu_torch.config import apply_overrides, parse_ini
    from piccolo_tpu_torch.serve import LocalizeService

    return LocalizeService(apply_overrides(parse_ini(CONFIG), extra),
                           max_rooms=2, device="cpu")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--queries", type=int, default=1,
                    help="panoramas written per room")
    ap.add_argument("--modes", default="False,True",
                    help="room_auto_probe values, comma-separated: False, "
                    "True or batched")
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--override", default="",
                    help="config overrides on top of configs/stanford.ini")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)

    import torch

    from piccolo_tpu_torch.data import obtain_gt_stanford, read_stanford
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.testing import write_synth_stanford

    torch.set_num_threads(4)
    tmp = tempfile.mkdtemp(prefix="room_auto_")
    tree = os.path.join(tmp, "data")
    write_synth_stanford(tree, rooms=2, queries=args.queries, points=60000,
                         height=512, seed=7, oracle="raycast")
    pcds = sorted(glob.glob(os.path.join(tree, "stanford", "pcd_not_aligned",
                                         "area_1", "*.txt")))
    panos = sorted(glob.glob(os.path.join(tree, "stanford", "pano", "area_1",
                                          "*.png")))
    rooms = {os.path.basename(p): read_stanford(p, 1) for p in pcds}
    lines = []
    for pkg in args.packages.split(","):
        for mode in args.modes.split(","):
            svc = _services(pkg, mode, args.override)
            for name, (xyz, rgb) in rooms.items():
                svc.load_room(xyz.astype(np.float32), rgb.astype(np.float32),
                              name=name)
            for pano in panos:
                t0 = time.time()
                out = svc.localize(imread_rgb(pano), room="auto")
                gt_t, _ = obtain_gt_stanford(tree, 1, os.path.basename(pano))
                scores = {k: float(v) for k, v in out["room_scores"].items()}
                line = dict(
                    package=pkg, room_auto_probe=mode, override=args.override,
                    query=os.path.basename(pano).split("_")[1],
                    own_room=os.path.basename(pano).split("_")[2] + "_"
                    + os.path.basename(pano).split("_")[3] + ".txt",
                    picked=out["room"], room_scores=scores,
                    order=sorted(scores, key=scores.get),
                    t_err=float(np.linalg.norm(np.asarray(out["t"])
                                               - np.ravel(gt_t))),
                    seconds=time.time() - t0)
                print(json.dumps(line), flush=True)
                lines.append(line)
            del svc
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
