"""Write a synthetic dataset in the Stanford2D-3D-S / OmniScenes layouts
(port of ``scripts/make_synth_dataset.py``).

    python -m piccolo_tpu_torch.synth_dataset --root /tmp/synth_data \\
        [--rooms 2] [--queries 3] [--points 30000] [--height 512] \\
        [--seed 7] [--datasets stanford,omniscenes] \\
        [--oracle splat|raycast] [--realism ARM] [--realism-val V]

Textured box rooms, ground-truth panoramas and poses in the directory
layouts the CLIs read (``testing.write_synth_stanford`` /
``write_synth_omniscenes``), so both run end to end with no download.
The same flags, files and random stream as the JAX script: both datasets
draw from one generator, Stanford first.  Everything is rendered on the
host.
"""

from __future__ import annotations

import argparse

import numpy as np

from .testing import REALISM_DEFAULTS, write_synth_omniscenes, write_synth_stanford

__all__ = ["main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--rooms", type=int, default=2)
    ap.add_argument("--queries", type=int, default=3)
    ap.add_argument("--points", type=int, default=30000)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--datasets", default="stanford,omniscenes")
    ap.add_argument("--oracle", default="splat", choices=["splat", "raycast"],
                    help="'raycast' writes dense camera-like panoramas "
                         "(cluttered rooms, geometric occlusion) instead "
                         "of cloud splats: colour preprocessing behaves as "
                         "on real captures")
    ap.add_argument("--realism", default=None,
                    choices=list(REALISM_DEFAULTS),
                    help="capture-realism degradation (raycast only; "
                         "testing.apply_*_realism)")
    ap.add_argument("--realism-val", type=float, default=None,
                    help="arm strength (defaults: noise 0.02, jpeg 60, "
                         "blur 9 px, vignette 0.4, depth-noise 0.01 m, "
                         "holes 0.10)")
    args = ap.parse_args(argv)
    if args.realism and args.oracle != "raycast":
        raise SystemExit("--realism needs --oracle raycast")

    rng = np.random.default_rng(args.seed)
    kw = dict(rooms=args.rooms, queries=args.queries, points=args.points,
              height=args.height, seed=rng, oracle=args.oracle,
              realism=args.realism, realism_val=args.realism_val)
    if "stanford" in args.datasets:
        write_synth_stanford(args.root, **kw)
    if "omniscenes" in args.datasets:
        write_synth_omniscenes(args.root, **kw)
    print(f"synthetic dataset written to {args.root}")


if __name__ == "__main__":
    main()
