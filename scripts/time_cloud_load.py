#!/usr/bin/env python3
"""Time the loading of a large text point cloud, as the CLIs load a room.

    python3 scripts/time_cloud_load.py [--reps 3] [--out FILE]

Writes ``scripts/measure_stretch.py``'s room (``make_room`` at 170,000
points a wall, seed 7: 1.02 M points) as ``x y z r g b`` text, as the
synthetic dataset trees write clouds, into a temporary directory, then
times ``data.loader.load_txt_pointcloud`` on it ``--reps`` times (each a
full parse of the file into float64) and prints one JSON line: the points,
the file's bytes, every time and their median, the host's CPU count, and
the card's name and power limit where ``nvidia-smi`` finds one.  Host
work: it needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--per-wall", type=int, default=170000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from piccolo_tpu_torch.data.loader import load_txt_pointcloud
    from piccolo_tpu_torch.testing import _write_cloud, make_room

    xyz, rgb = make_room(np.random.default_rng(7), n_per_wall=args.per_wall,
                         size=(6.0, 4.0, 3.0), texture="checker")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except FileNotFoundError:
        smi = []
    with tempfile.TemporaryDirectory(prefix="piccolo_cloud_") as tmp:
        path = os.path.join(tmp, "room.txt")
        _write_cloud(path, xyz, rgb)
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            got, _ = load_txt_pointcloud(path)
            times.append(time.perf_counter() - t0)
        nbytes = os.path.getsize(path)
    line = json.dumps(dict(
        points=int(got.shape[0]), file_bytes=nbytes, load_s=times,
        median_s=float(np.median(times)), cpus=os.cpu_count(),
        card=smi[0] if smi else None))
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
