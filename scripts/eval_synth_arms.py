#!/usr/bin/env python3
"""The port's synthetic accuracy matrix: ``piccolo_tpu_torch.eval_synth``
over the JAX package's evaluation arms, in one process on one card.

    python3 scripts/eval_synth_arms.py [--arms NAME,NAME] [--extra=FLAGS]
        [--out FILE.json]

Stanford profile, splat oracle (6 rooms x 4 queries): float32 (the
script's default), auto, --full-rot, --prune 30,2, --sharpen.  Ray-cast
oracle, Stanford profile: default, --floor-ref, --perturb gamma with and
without --match-color, --seam-gt with and without --seam-wrap, and each
--realism arm at its default strength.  OmniScenes profile, ray-cast
oracle (8 rooms x 4 queries): float32 and auto, each with and without
--sharpen.  Every arm takes the script's default seed.  Prints each arm's
summary as it ends and, with ``--out``, writes them all (each with the
card's name and power limit) to that file as each arm ends.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from piccolo_tpu_torch import eval_synth  # noqa: E402

RAY = ["--oracle", "raycast"]
OMNI = ["--profile", "omniscenes", "--oracle", "raycast", "--rooms", "8"]
ARMS = {
    "splat": [],
    "splat-auto": ["--descent-table", "auto"],
    "splat-full-rot": ["--full-rot"],
    "splat-prune": ["--prune", "30,2"],
    "splat-sharpen": ["--sharpen"],
    "ray": RAY,
    "ray-floor-ref": RAY + ["--floor-ref"],
    "ray-gamma": RAY + ["--perturb", "gamma"],
    "ray-gamma-match": RAY + ["--perturb", "gamma", "--match-color"],
    "ray-seam": RAY + ["--seam-gt"],
    "ray-seam-wrap": RAY + ["--seam-gt", "--seam-wrap"],
    "ray-noise": RAY + ["--realism", "noise"],
    "ray-jpeg": RAY + ["--realism", "jpeg"],
    "ray-blur": RAY + ["--realism", "blur"],
    "ray-vignette": RAY + ["--realism", "vignette"],
    "ray-depth-noise": RAY + ["--realism", "depth-noise"],
    "ray-holes": RAY + ["--realism", "holes"],
    "omni-float32": OMNI,
    "omni-auto": OMNI + ["--descent-table", "auto"],
    "omni-float32-sharpen": OMNI + ["--sharpen"],
    "omni-auto-sharpen": OMNI + ["--descent-table", "auto", "--sharpen"],
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arms", default=",".join(ARMS),
                    help="comma-separated arm names (default: all)")
    ap.add_argument("--out", default=None,
                    help="JSON file for every arm's summary and query lines")
    ap.add_argument("--extra", default="",
                    help="flags added to every arm, given with '=', e.g. "
                         "--extra='--rooms 1 --queries 1' for a short "
                         "rehearsal, --extra=--no-slab or "
                         "--extra='--device cpu'")
    args = ap.parse_args(argv)
    names = args.arms.split(",")
    unknown = [n for n in names if n not in ARMS]
    if unknown:
        raise SystemExit(f"unknown arms {unknown} (have {list(ARMS)})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = {}
    for name in names:
        argv_arm = ARMS[name] + args.extra.split()
        out = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            summary = eval_synth.main(argv_arm)
        done[name] = dict(argv=argv_arm, summary=summary,
                          queries=[ln for ln in out.getvalue().splitlines()
                                   if ln.startswith("room ")],
                          wall_s=time.time() - t0)
        print(f"{name} ({done[name]['wall_s']:.1f} s): "
              f"{json.dumps(summary)}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(done, f, indent=1)
    return done


if __name__ == "__main__":
    main()
