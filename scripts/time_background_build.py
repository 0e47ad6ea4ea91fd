#!/usr/bin/env python3
"""Time the first queries of a room whose slab plan builds in the background.

    python scripts/time_background_build.py [--repo DIR] [--label NAME]

Writes ``chip_smoke.py``'s CLI tree (one ray-cast Stanford room, 60,000
points, 4 queries of 1024x512, seed 7) to a temporary directory, builds the
kernels, and runs the CLI of the port found in DIR (default: this
checkout) under ``configs/stanford.ini`` with ``sharpen_color=False`` and
``slab_background_build=True``.  The process is fresh, so no descent graph
is cached: the first query captures its graphs while the room's plan
builds on its own thread, and the queries after it use the plan once it is
there.  Prints one JSON line: each query's route and seconds (from the
CLI's CSV), the span of the plan-build thread and of the whole run, both
from the CLI's start, and the card's name and power limit
(``nvidia-smi``).  Needs a card; run it once per checkout to compare two.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=ROOT,
                    help="the checkout whose piccolo_tpu_torch runs")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch

    from piccolo_tpu_torch.kernels._build import build_all
    from piccolo_tpu_torch.main import main as cli_main
    from piccolo_tpu_torch.testing import write_synth_stanford

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build_all()
    tmp = tempfile.mkdtemp(prefix="piccolo_bg_")
    try:
        tree = os.path.join(tmp, "data")
        write_synth_stanford(tree, rooms=1, queries=4, points=60000,
                             height=512, seed=7, oracle="raycast")
        log_dir = os.path.join(tmp, "log")
        spans, done = {}, threading.Event()

        def watch():  # the plan-build threads' first and last sightings
            while not done.is_set():
                now = time.perf_counter()
                for t in threading.enumerate():
                    if t.name.startswith(("piccolo-plan-build",
                                          "piccolo-hist-plan-build")):
                        spans.setdefault(t.name, [now, now])[1] = now
                time.sleep(0.002)

        watcher = threading.Thread(target=watch, daemon=True)
        buf = io.StringIO()
        t0 = time.perf_counter()
        watcher.start()
        with contextlib.redirect_stdout(buf):
            acc = cli_main([
                "--config", os.path.join(repo, "configs", "stanford.ini"),
                "--log", log_dir, "--no-tensorboard", "--override",
                f"data_root={tree},sharpen_color=False,"
                "slab_background_build=True"])
            for t in threading.enumerate():
                if t.name.startswith(("piccolo-plan", "piccolo-hist")):
                    t.join()
        wall = time.perf_counter() - t0
        done.set()
        watcher.join()
        routes = [ln.split(":", 1)[1].strip()
                  for ln in buf.getvalue().splitlines()
                  if ln.startswith("route :")]
        with open(os.path.join(log_dir, "stanford_results.csv"),
                  newline="") as f:
            rows = list(csv.reader(f))[1:]
        print(json.dumps(dict(
            label=args.label, repo=repo, card=smi, accuracy=acc,
            query_s=[float(r[9]) for r in rows], routes=routes,
            build_spans_s={k: [round(a - t0, 4), round(b - t0, 4)]
                           for k, (a, b) in spans.items()},
            wall_s=round(wall, 4))), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
