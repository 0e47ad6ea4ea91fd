"""Repeated runs of one cell, and the spread that a bound is set from.

    python3 benchmark/sets.py --workload <cell> --seeds 1,2,3,4,5,6 \
        [--sets 2] [--seconds 50] [--traced-seeds 7,8,9] [--out FILE]

Runs ``run.py`` once a seed in each set (a fresh process each, as the
check does), then the traced seeds with ``--trace 1``.  Writes one JSON
line a run (its result line, exit code, wall seconds and the end of its
standard error) and prints, for each end-to-end metric and set, the median
and the spread: the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.time()
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return dict(workload=workload, seed=seed, trace=trace, rc=p.returncode,
                wall_s=time.time() - t0, result=result,
                stderr=p.stderr[-3000:])


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=50)
    ap.add_argument("--traced-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    runs = []
    plan = [(k, s, 0) for k in range(args.sets) for s in seeds]
    plan += [(args.sets, int(s), 1) for s in args.traced_seeds.split(",")
             if s]
    for k, seed, trace in plan:
        r = dict(one(args.workload, seed, args.seconds, trace), set=k)
        runs.append(r)
        res = r["result"] or {}
        print(json.dumps(dict(set=k, seed=seed, trace=trace, rc=r["rc"],
                              wall_s=round(r["wall_s"], 1),
                              correct=res.get("correct"),
                              metrics={m: v["value"] for m, v in
                                       res.get("metrics", {}).items()},
                              checks=res.get("checks"))), flush=True)
        if r["rc"] != 0 or not res.get("correct"):
            print(r["stderr"][-1500:], flush=True)
        if sink:
            sink.write(json.dumps(r) + "\n")
            sink.flush()
    for k in range(args.sets):
        vals = {}
        for r in runs:
            if r["set"] == k and r["trace"] == 0 and r["result"]:
                for m, v in r["result"]["metrics"].items():
                    vals.setdefault(m, []).append(v["value"])
        for m, v in sorted(vals.items()):
            if len(v) >= 2:
                med, sp = spread(v)
                print(f"set {k} {m}: median {med!r} spread {sp!r} "
                      f"values {v}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
