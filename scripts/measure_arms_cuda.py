#!/usr/bin/env python3
"""Every arm of the four measurement scripts at their defaults, one fresh
process an arm, on the card.

    python3 scripts/measure_arms_cuda.py [--arms NAME,NAME]
        [--out FILE.json] [--timeout S]

Tracking (``scripts/measure_tracking_cuda.py``, 60 frames, 60,000 points):
1024x512 at 30 iterations, ``--teleport``, ``--height 1024``,
``--num-iter 15``, ``--teleport-every 10``.  Serving
(``scripts/measure_serving_cuda.py``): ``sustained``, ``http`` (default
against descent prune), ``room-auto`` with the probe off, on and batched at
the Stanford scale and off and batched at 240,000 points and 4096x2048,
``coldstart`` three times (off, then a cache directory empty and
populated), ``track-streams`` with ``track_batch`` on and off.  The plan
lifecycle (``scripts/measure_plan_lifecycle_cuda.py``, 240,000 points,
2048x1024): ``--sync``, the background default, ``--no-cache``, and
``--disk`` twice on one directory at 30,000 points and 1024x512, whose
plan is under the 3 GB that the disk cache writes at most.  The sharded restart
(``scripts/measure_sharded_coldstart_cuda.py``) twice on one directory.
Each arm's command runs in a process of its own, as the JAX package's
records were taken; the cache directories, the serving modes' default
executable cache among them (``PICCOLO_EXEC_CACHE`` unless it is set),
live in a temporary directory of this run.  Prints each arm's last JSON
line as it ends and, with ``--out``, writes every arm's command, JSON line, printed lines, wall
seconds and the card's name and power limit to that file as each ends.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACK = ["scripts/measure_tracking_cuda.py"]
SERVE = ["scripts/measure_serving_cuda.py"]
PLAN = ["scripts/measure_plan_lifecycle_cuda.py", "--cache-dir"]
SHARD = ["scripts/measure_sharded_coldstart_cuda.py", "--exec-cache"]
DENSE = ["--points", "240000", "--height", "2048"]
# the disk arms' room: its f32 plan under the 3 GB the disk cache writes at
# most; at 1024x512 its splat renders light 30% of the pixels (10% at
# 2048x1024, too sparse to localize; the 240,000-point room lights 44%)
DISK = ["--points", "30000", "--height", "512"]
# "{tmp}" is the run's temporary directory
ARMS = {
    "track": TRACK,
    "track-teleport": TRACK + ["--teleport"],
    "track-h1024": TRACK + ["--height", "1024"],
    "track-iter15": TRACK + ["--num-iter", "15"],
    "track-teleport-every": TRACK + ["--teleport-every", "10"],
    "serve-sustained": SERVE + ["--mode", "sustained"],
    "serve-http": SERVE + ["--mode", "http"],
    "serve-auto-off": SERVE + ["--mode", "room-auto", "--probe", "off"],
    "serve-auto-on": SERVE + ["--mode", "room-auto", "--probe", "on"],
    "serve-auto-batched": SERVE + ["--mode", "room-auto", "--probe",
                                   "batched"],
    "serve-auto-dense-off": SERVE + ["--mode", "room-auto", "--probe",
                                     "off"] + DENSE,
    "serve-auto-dense-batched": SERVE + ["--mode", "room-auto", "--probe",
                                         "batched"] + DENSE,
    "serve-coldstart-off": SERVE + ["--mode", "coldstart", "--exec-cache",
                                    ""],
    "serve-coldstart-write": SERVE + ["--mode", "coldstart", "--exec-cache",
                                      "{tmp}/serve_exec"],
    "serve-coldstart-populated": SERVE + ["--mode", "coldstart",
                                          "--exec-cache", "{tmp}/serve_exec"],
    "serve-track-streams-on": SERVE + ["--mode", "track-streams", "--batch",
                                       "on"],
    "serve-track-streams-off": SERVE + ["--mode", "track-streams", "--batch",
                                        "off"],
    "plan-sync": PLAN + ["{tmp}/plans_sync", "--sync"],
    "plan-background": PLAN + ["{tmp}/plans_background"],
    "plan-no-cache": PLAN + ["{tmp}/plans_no_cache", "--no-cache"],
    "plan-disk-write": PLAN + ["{tmp}/plans_disk", "--disk"] + DISK,
    "plan-disk-load": PLAN + ["{tmp}/plans_disk", "--disk"] + DISK,
    "sharded-first": SHARD + ["{tmp}/sharded_exec"],
    "sharded-restart": SHARD + ["{tmp}/sharded_exec"],
}


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arms", default=",".join(ARMS),
                    help="comma-separated arm names (default: all, in "
                         "order; a later coldstart, disk or sharded arm "
                         "reads the directory its earlier one wrote)")
    ap.add_argument("--out", default=None,
                    help="JSON file for every arm's result")
    ap.add_argument("--timeout", type=float, default=1800,
                    help="seconds an arm may take")
    args = ap.parse_args(argv)
    names = args.arms.split(",")
    unknown = [n for n in names if n not in ARMS]
    if unknown:
        raise SystemExit(f"unknown arms {unknown} (have {list(ARMS)})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    card = _card()
    print(f"card: {card}", flush=True)
    done = {}
    with tempfile.TemporaryDirectory(prefix="piccolo_arms_") as tmp:
        # the serving modes' default executable cache: this run's own
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        env.setdefault("PICCOLO_EXEC_CACHE", os.path.join(tmp, "bench_exec"))
        for name in names:
            cmd = [sys.executable] + [a.replace("{tmp}", tmp)
                                      for a in ARMS[name]]
            t0 = time.time()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      cwd=ROOT, env=env,
                                      timeout=args.timeout)
            except subprocess.TimeoutExpired as exc:
                proc = subprocess.CompletedProcess(
                    cmd, 124, exc.stdout or "", exc.stderr or "")
                if isinstance(proc.stdout, bytes):
                    proc.stdout = proc.stdout.decode(errors="replace")
                    proc.stderr = (proc.stderr or b"").decode(
                        errors="replace")
            lines = proc.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                result = None
            done[name] = dict(cmd=cmd[1:], rc=proc.returncode, result=result,
                              lines=lines[:-1], stderr=proc.stderr[-4000:],
                              wall_s=time.time() - t0, card=card)
            print(f"{name} (rc {proc.returncode}, "
                  f"{done[name]['wall_s']:.1f} s): {json.dumps(result)}",
                  flush=True)
            if proc.returncode != 0:
                print(proc.stdout[-3000:] + proc.stderr[-3000:], flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(done, f, indent=1)
    failed = [n for n, d in done.items() if d["rc"] != 0]
    if failed:
        raise SystemExit(f"arms failed: {failed}")
    return done


if __name__ == "__main__":
    main()
