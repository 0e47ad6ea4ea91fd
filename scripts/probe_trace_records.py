"""How many device records a torch.profiler session loses at its start, after
each phase of chip_smoke.py, with and without utils.maybe_trace's warm-up.

Run on a machine with a card, from the repository root:

    python3 scripts/probe_trace_records.py [--until PHASE] [--out FILE]

It runs chip_smoke.py's phases in order (their own checks included) and,
after each, opens four profiler sessions in turn: two plain, two opened by
``maybe_trace``'s warm-up kernels.  Each session then launches 40
one-element kernels, each waited for and 0.2 ms apart.  A launch whose kernel
has no record in the session's Chrome trace is lost.  One line a phase
gives the measured kernels lost in each session (and for the warm-up
sessions, the warm-up kernels lost); ``--out`` writes them as JSON.  It
stops after the phase named by ``--until`` (default: "omniscenes
tracking", the phase before the OmniScenes ``profile_dir`` run).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from piccolo_tpu_torch.utils import profiling  # noqa: E402

MEASURED = 40


class _Stop(Exception):
    pass


def session(warm: bool) -> dict:
    """One profiler session of MEASURED spaced kernels; the lost ones."""
    x = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        if warm:
            profiling._warm_up(range(1), profiling.TRACE_WARMUP_KERNELS)
        for _ in range(MEASURED):
            x.mul_(1.0001)
            torch.cuda.synchronize()
            time.sleep(0.0002)
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    recorded = {e["args"].get("correlation") for e in events
                if e.get("cat") == "kernel"}
    launches = [c for _, c in sorted(
        (e["ts"], e["args"]["correlation"]) for e in events
        if e.get("cat") == "cuda_runtime" and e.get("name") in cs.LAUNCH_CALLS)]
    lost = [c not in recorded for c in launches]
    return dict(lost=sum(lost[-MEASURED:]),
                warmup_lost=sum(lost[:-MEASURED]) if warm else None)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--until", default="omniscenes tracking")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    t0 = time.time()
    rows = []

    def probe(phase):
        runs = [dict(warm=w, **session(w)) for w in (False, False, True, True)]
        rows.append(dict(phase=phase, age_s=time.time() - t0, sessions=runs))
        print(f"after {phase!r} ({time.time() - t0:.0f} s): lost "
              + ", ".join(f"{'warm-up' if r['warm'] else 'plain'} "
                          f"{r['lost']}/{MEASURED}"
                          + (f" (warm-up {r['warmup_lost']})" if r["warm"]
                             else "") for r in runs), flush=True)

    timed = cs.timed

    def probed(name, fn, *a):
        out = timed(name, fn, *a)
        probe(name)
        if name == args.until:
            raise _Stop
        return out

    probe("import")
    cs.timed = probed
    try:
        cs.main()
    except _Stop:
        pass
    finally:
        cs.timed = timed
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
