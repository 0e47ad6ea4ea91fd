"""A copy of the benchmark at a size the CPU runs in seconds, for tests.

The cells keep their configurations' keys; the room, the images, the grids
and the budgets shrink, and the copy's limits are the ones set for this
size (``LIMITS``: its sound runs read under 0.02, the bfloat16 control and
the planted faults above 0.1).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
LIMITS = {"query_regret": 0.05, "track_regret": 0.05}


def make(dest: Path, image=(32, 64), points: int = 3000) -> Path:
    """Write the small copy under ``dest``; returns its root."""
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg["ini"].update(num_trans=12, num_yaw=4, num_pitch=2, num_roll=2,
                          num_intermediate=8, num_input=2, num_iter=30)
        cfg["program"]["track_num_iter"] = 10
        cfg["program"].pop("query_devices", None)
        cfg["room"]["points"] = points
        cfg["image"] = list(image)
        cfg["judge"] = {"query_images": 2, "track_frames": 64}
        cfg["limits"] = {k: LIMITS[k] for k in cfg["limits"]}
        path.write_text(json.dumps(cfg))
    for t in (dest / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(t.read_text())
        mix.update(warm_seconds=0.2, trace_seconds=1.0)
        if "poses" in mix:
            mix["poses"] = 4
        if "frames" in mix:
            mix["frames"] = 6
        t.write_text(json.dumps(mix))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


def run(root: Path, workload: str, seed: int, seconds: float = 1.5,
        trace: bool = False) -> dict:
    import time

    from benchmark import run as run_mod
    from benchmark import spec as spec_mod

    doc = spec_mod.load_spec(root)
    return run_mod.run_cell(doc, workload, seed, seconds, trace,
                            device="cpu", t0=time.time(), root=root,
                            log=lambda *a: None)
