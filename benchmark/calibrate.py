"""Readings that the limits of ``correct`` are set from; not part of a run.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 4] [--out FILE]

For each seed, in one process: the cell's room, requests and service as a
run builds them, a short window of the cell's own traffic, and the
reference's judgement of answers drawn from the seed (``run.check``): the
program's readings.  On the control seeds, the same judgement of other
answerers put in the program's place:

* ``control``: the reference itself computed in bfloat16, the precision
  below the configuration's float32 (its texels are already bfloat16);
* ``unchanged``: a descent whose steps return their state unchanged (a
  full query answers its best start after stages 1 and 2; a tracked frame
  answers the pose it was sent);
* ``altered``: the reference's answer moved 5 cm along x where it is made;
* ``half_batch`` (tracked frames): each frame answered with another
  stream's answer, as a batch that computed half its rows would.

One JSON line a seed.  Run on the card at the cell's own size.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import judge, reference, run, spec  # noqa: E402

BF16 = torch.bfloat16


def _pick(records, cfg, seed):
    """The answers ``run.check`` judges, drawn the same way."""
    rng = np.random.default_rng([abs(int(seed)), 7])
    ok = [r for r in records if "error" not in r]
    full = [r for r in ok if not r["tracked"]]
    tracked = [r for r in ok if r["tracked"]]
    out = {}
    if full:
        seen = sorted({r["image"] for r in full})
        out["images"] = [int(i) for i in rng.choice(
            seen, min(int(cfg["judge"]["query_images"]), len(seen)),
            replace=False)]
    if tracked:
        pick = rng.choice(len(tracked), min(int(cfg["judge"]["track_frames"]),
                                            len(tracked)), replace=False)
        out["frames"] = [tracked[i] for i in sorted(int(i) for i in pick)]
    return out


def faults(cfg, xyz, rgb, wl, records, seed, device) -> dict:
    ref_cfg = dict(cfg["ini"], **cfg["program"])
    room = reference.Room(xyz, rgb, ref_cfg, device)
    still = reference.Room(xyz, rgb, dict(ref_cfg, num_iter=0), device)
    picked = _pick(records, cfg, seed)
    out = {}
    if "images" in picked:
        imgs = {i: wl.images[i] for i in picked["images"]}

        def altered(img):
            a = room.localize(img)
            return dict(t=a["t"] + np.float32([0.05, 0, 0]), R=a["R"])

        for name, fn in (("control", lambda img: room.localize(img, BF16)),
                         ("unchanged", still.localize),
                         ("altered", altered)):
            out[f"query_regret.{name}"] = judge.judge_queries(
                room, imgs, [], answer_fn=fn)["regret"]
    if "frames" in picked:
        frames = [dict(img=wl.images[r["image"]], image_key=r["image"],
                       prev=r["prev"], t=r["t"], R=r["R"], client=r["client"])
                  for r in picked["frames"]]

        def control(fr, main, rgb_):
            return room.track(fr["img"], fr["prev"]["t"], fr["prev"]["ypr"],
                              BF16, main=main, rgb=rgb_)

        def unchanged(fr, main, rgb_):
            R = reference.rot_from_ypr(torch.tensor(fr["prev"]["ypr"]))
            return dict(t=np.asarray(fr["prev"]["t"], np.float32),
                        R=R.numpy())

        def altered(fr, main, rgb_):
            a = room.track(fr["img"], fr["prev"]["t"], fr["prev"]["ypr"],
                           main=main, rgb=rgb_)
            return dict(t=a["t"] + np.float32([0.05, 0, 0]), R=a["R"])

        def half_batch(fr, main, rgb_):
            other = next((f for f in frames if f["client"] != fr["client"]),
                         fr)
            return dict(t=other["t"], R=other["R"])

        for name, fn in (("control", control), ("unchanged", unchanged),
                         ("altered", altered), ("half_batch", half_batch)):
            out[f"track_regret.{name}"] = judge.judge_tracked(
                room, frames, answer_fn=fn)["regret"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.cache_env()
    from piccolo_tpu_torch.serve import LocalizeService

    spec_doc = spec.load_spec()
    cell = spec.cell(spec_doc, args.workload)
    cfg = spec.load_config(spec_doc, cell["config"])
    mix = spec.load_traffic(cell["traffic"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        xyz, rgb, wl = run.build(cfg, mix, seed, "cuda")
        svc = LocalizeService(run.program_config(cfg), max_pending=int(
            cfg.get("max_pending", 8)), device="cuda")
        svc.load_room(xyz, rgb, name="room", warm_shape=tuple(cfg["image"]))
        if wl.kind == "track":
            wl.seed_streams(svc)
        warm = []
        wl.run(svc, float(mix["warm_seconds"]), warm)
        records = []
        wl.run(svc, args.seconds, records, k0=len(warm))
        del svc
        gc.collect()
        torch.cuda.empty_cache()
        line = dict(workload=args.workload, seed=seed,
                    answers=len(records),
                    failed=sum("error" in r for r in records))
        for k, (v, _) in run.check(cfg, xyz, rgb, wl, records, seed,
                                   "cuda").items():
            line[k] = v
        if seed in controls:
            line.update(faults(cfg, xyz, rgb, wl, records, seed, "cuda"))
        line["seconds"] = time.time() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
