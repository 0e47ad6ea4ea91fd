#!/usr/bin/env python3
"""Serving's room-auto picks over more query seeds, and its tracked streams,
under each descent table, in either package.

    python3 scripts/serving_seed_sets.py [--package port|jax]
        [--device cuda|cpu] [--mode room-auto|track-streams]
        [--offsets 0,1000] [--tables auto,float32]

Runs a mode of the serving measurement script of the package,
``scripts/measure_serving_cuda.py`` (the port; the card by default) or
``scripts/measure_serving.py`` (the JAX package, on the CPU: run it with
``JAX_PLATFORMS=cpu``), with its executable cache off, once for each table
of ``--tables`` (``descent_table``):

  room-auto      the probe off, four rooms x 3 queries, at 240,000 points
                 and 2048x1024 (the JAX record's dense arm), once for each
                 ``--offsets`` value added to the query seeds (0: the
                 script's own queries).  Each query's pick and every
                 room's loss are printed on a line of their own, then the
                 script's JSON line.
  track-streams  2 streams x 4 frames with ``track_batch``, three times,
                 then 6 x 12 once, at 60,000 points and 1024x512
                 (``chip_smoke.py`` phase 38's size and the mode's
                 default).

Each run's lines open with ``== <mode> offset <n> table <t>``.  A room-auto
query at 240,000 points and 2048x1024 takes about a second on an H100 and
two to three minutes on the CPU in either package.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _script(package: str):
    name = "measure_serving_cuda" if package == "port" else "measure_serving"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._CFG["exec_cache_dir"] = None
    return mod


def _print_jax_picks():
    """Print each auto query's pick and room losses, as the port's script
    does itself."""
    import piccolo_tpu.serve as jserve

    real = jserve.LocalizeService.localize
    count = [0]

    def localize(self, img, room=None, **kw):
        out = real(self, img, room=room, **kw)
        if room == "auto":
            scores = sorted((v, k) for k, v in out["room_scores"].items())
            print(f"query {count[0]}: picked {out['room']}; losses "
                  + ", ".join(f"{k} {v:.6g}" for v, k in scores), flush=True)
            count[0] += 1
        return out

    jserve.LocalizeService.localize = localize


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the port's device (the JAX package: the CPU)")
    ap.add_argument("--mode", choices=("room-auto", "track-streams"),
                    default="room-auto")
    ap.add_argument("--offsets", default="0,1000")
    ap.add_argument("--tables", default="auto,float32")
    args = ap.parse_args(argv)
    mod = _script(args.package)
    kw = {}
    if args.package == "port":
        import torch

        from piccolo_tpu_torch.device import resolve_device

        kw["dev"] = resolve_device(args.device)
        if kw["dev"].type == "cuda":
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip(), flush=True)
    else:
        _print_jax_picks()
    images = mod._query_images
    offset = [0]

    def shifted(*a, seed=9, **k):
        # the auto queries draw seeds 99 + i; the baseline's 7 stays
        return images(*a, seed=seed + offset[0] if seed >= 99 else seed, **k)

    mod._query_images = shifted
    offsets = ([int(o) for o in args.offsets.split(",")]
               if args.mode == "room-auto" else [0])
    for off in offsets:
        offset[0] = off
        for table in args.tables.split(","):
            mod._CFG["descent_table"] = table
            print(f"== {args.mode} offset {off} table {table}", flush=True)
            if args.mode == "room-auto":
                if args.package == "port":
                    mod.mode_room_auto(kw["dev"], probe=False,
                                       points=240000, height=1024)
                else:
                    mod.mode_room_auto(probe=False, points=240000,
                                       height=1024)
            else:
                for k, frames in [(2, 4)] * 3 + [(6, 12)]:
                    mod.mode_track_streams(k, frames, True, 60000, 512, **kw)
            gc.collect()
            if kw and kw["dev"].type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
