"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The system under test is ``piccolo_tpu_torch.serve.LocalizeService``, in
process.  A run builds the cell's room (a ray-cast scene from the seed:
checker walls and two occluders), renders its panoramas on the card,
starts the service on the deployment's configuration, loads the room with
its shapes warmed up, seeds the camera streams of a tracking mix and warms
the mix's own traffic; that is ``setup_s``.  Then the clients run closed
loops for ``--seconds`` (``--trace 1``: the mix's ``trace_seconds`` under
``torch.profiler``).  Once the window has closed, the memory peak is read,
the service is dropped, and the plain reference (``reference.py``) judges
answers drawn from the seed (``judge.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read by ``metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared and its limit, which also end standard error.

Exit codes: 0 with a result; 3 without enough CUDA cards; 4 when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "piccolo_tpu")


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = root / "benchmark" / "_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import judge, reference, roofline, scene, spec  # noqa: E402
from benchmark import traffic as traffic_mod  # noqa: E402


def forbidden_modules():
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program_config(cfg: dict, root: Path = ROOT, on_card: bool = True):
    """The deployment's configuration as the program takes it: the
    shipped ini's keys and the deployment's own, with (on the card) the
    kernel library store at a fixed path inside the checkout."""
    from piccolo_tpu_torch.config import make_config

    values = dict(cfg["ini"], **cfg["program"])
    if on_card:
        values["exec_cache_dir"] = str(root / "benchmark" / "_cache" / "lib")
    return make_config(**values)


def image_sizes(cfg: dict):
    """(init, main) image shapes of a query, by PICCOLO's preparation."""
    H, W = cfg["image"]
    ini = cfg["ini"]
    omni = "mni" in ini["dataset"]
    dh, dw = ini.get("init_downsample_h", 1), ini.get("init_downsample_w", 1)
    if omni:  # the reference halves the init downsample for OmniScenes
        dh, dw = max(dh // 2, 1), max(dw // 2, 1)
    mh, mw = ini.get("main_downsample_h", 1), ini.get("main_downsample_w", 1)
    return (H // dh, W // dw), (H // mh, W // mw)


def nearest_rank(values, q: float) -> float:
    if not values:
        return math.nan
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def build(cfg: dict, mix: dict, seed: int, device):
    """The room and the requests from the seed."""
    room = cfg["room"]
    rng = np.random.default_rng(abs(int(seed)))
    sc = scene.make_scene(rng, tuple(room["size"]), int(room["occluders"]),
                          room.get("texture", "checker"),
                          bool(room.get("floor_at_zero", False)))
    xyz, rgb = scene.scene_cloud(sc, rng, int(room["points"]))
    wl = traffic_mod.Workload(mix, sc, rng, tuple(cfg["image"]),
                              room.get("z_range"), device)
    return xyz, rgb, wl


def end_to_end(records, t_end: float, seconds: float, dataset: str,
               gt) -> dict:
    full = [r for r in records if not r["tracked"]]
    tracked = [r for r in records if r["tracked"]]
    inf = math.inf
    lat = lambda r: inf if "error" in r else r["t_done"] - r["t_issue"]  # noqa: E731
    ok = sum(1 for r in records if "error" not in r and judge.localized(
        dataset, gt[r["image"]][0], gt[r["image"]][1], r["t"], r["R"]))
    out = {}
    if full:
        done = sum(1 for r in full if "error" not in r and r["t_done"] <= t_end)
        out["queries_per_s"] = (done / seconds, "queries/s")
        out["query_p90_s"] = (nearest_rank([lat(r) for r in full], 0.9), "s")
    if tracked:
        out["frame_p95_ms"] = (1e3 * nearest_rank([lat(r) for r in tracked],
                                                  0.95), "ms")
    if records:
        out["localized_pct"] = (100.0 * ok / len(records), "%")
    return out


def check(cfg: dict, xyz, rgb, wl, records, seed: int, device) -> dict:
    """The numbers compared, each (value, limit), from the reference's
    judgement of answers drawn from the seed."""
    jcfg = cfg["judge"]
    ref_cfg = dict(cfg["ini"], **cfg["program"])
    room = reference.Room(xyz, rgb, ref_cfg, device)
    rng = np.random.default_rng([abs(int(seed)), 7])
    limits = cfg["limits"]
    out = {}
    answered = [r for r in records if "error" not in r]
    full = [r for r in answered if not r["tracked"]]
    if full:
        seen = sorted({r["image"] for r in full})
        pick = rng.choice(seen, min(int(jcfg["query_images"]), len(seen)),
                          replace=False)
        res = judge.judge_queries(room, {int(i): wl.images[int(i)]
                                         for i in pick}, full)
        out["query_regret"] = (res["regret"], limits["query_regret"])
        out["query_t_gap_m"] = (res["t_gap_max_m"], None)
    tracked = [r for r in answered if r["tracked"]]
    if tracked:
        pick = rng.choice(len(tracked), min(int(jcfg["track_frames"]),
                                            len(tracked)), replace=False)
        frames = [dict(img=wl.images[tracked[i]["image"]],
                       image_key=tracked[i]["image"], prev=tracked[i]["prev"],
                       t=tracked[i]["t"], R=tracked[i]["R"])
                  for i in sorted(int(i) for i in pick)]
        res = judge.judge_tracked(room, frames)
        out["track_regret"] = (res["regret"], limits["track_regret"])
        out["track_t_gap_m"] = (res["t_gap_max_m"], None)
    return out


def shapes(cfg: dict, xyz) -> dict:
    ini = cfg["ini"]
    init_hw, main_hw = image_sizes(cfg)
    pairs = (reference.trans_grid(xyz, ini).shape[0]
             * reference.rot_grid(ini).shape[0])
    return dict(pairs=pairs, points=int(xyz.shape[0]), init_hw=init_hw,
                main_hw=main_hw, candidates=int(ini["num_intermediate"]),
                starts=int(ini["num_input"]), iterations=int(ini["num_iter"]),
                blocks=int(ini["num_split_h"]) * int(ini["num_split_w"]))


def run_cell(spec_doc: dict, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0: float = None, log=None,
             root: Path = ROOT) -> dict:
    """One run of a cell; returns the result object (``checks`` last)."""
    import torch

    from benchmark import trace as trace_mod

    t0 = T0 if t0 is None else t0
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cell = spec.cell(spec_doc, workload)
    cfg = spec.load_config(spec_doc, cell["config"], root)
    mix = spec.load_traffic(cell["traffic"], root / "benchmark")
    on_card = torch.device(device).type == "cuda"
    chips = int(cell["chips"])

    from piccolo_tpu_torch import solver
    from piccolo_tpu_torch.serve import LocalizeService

    xyz, rgb, wl = build(cfg, mix, seed, device)
    svc = LocalizeService(program_config(cfg, root, on_card),
                          max_pending=int(cfg.get("max_pending", 8)),
                          device=device)
    svc.load_room(xyz, rgb, name="room", warm_shape=tuple(cfg["image"]))
    if wl.kind == "track":
        wl.seed_streams(svc)
    warm = []
    wl.run(svc, float(mix["warm_seconds"]), warm, k0=0)
    if on_card:
        for i in range(chips):
            torch.cuda.synchronize(i)
    captures0 = solver.graph_stats()["captures"]
    setup_s = time.time() - t0
    records = []
    summary = None
    if trace:
        cards = chips if on_card else 0
        with trace_mod.session(cards) as prof:
            with torch.profiler.record_function(trace_mod.WINDOW_SPAN):
                t_start, t_end = wl.run(svc, float(mix["trace_seconds"]),
                                        records, k0=len(warm))
        summary = trace_mod.read(prof, max(cards, 1))
        log(f"trace: device ops charged to stages by {summary.get('attributed')}"
            f", spans {summary.get('spans')}")
        window = t_end - t_start
    else:
        t_start, t_end = wl.run(svc, seconds, records, k0=len(warm))
        window = seconds
    captures = solver.graph_stats()["captures"] - captures0
    if captures:
        log(f"warning: {captures} descent graph(s) captured inside the window")
    peak = (max(torch.cuda.max_memory_allocated(i) for i in range(chips))
            if on_card else 0)
    del svc
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    dataset = cfg["ini"]["dataset"]
    failed = sum(1 for r in records if "error" in r)
    for r in records:
        if "error" in r:
            log(f"request failed: {r['error']}")
    metrics = {}
    breakdown = None
    if trace:
        ctx = dict(records=records, trace=summary or {}, shapes=shapes(cfg, xyz),
                   roofline=roofline, window_s=window)
        for m in spec.per_layer(spec_doc, workload):
            v = spec.reader(m["name"], root / "benchmark")(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary:
            breakdown = dict(device_ops=summary["device_ops"],
                             idle_gaps=summary["idle_gaps"])
    else:
        e2e = end_to_end(records, t_end, seconds, dataset, wl.gt)
        e2e["setup_s"] = (setup_s, "s")
        for m in spec.end_to_end(spec_doc, workload):
            if m["name"] in e2e:
                v, unit = e2e[m["name"]]
                if _finite(v) is not None:
                    metrics[m["name"]] = {"value": v, "unit": unit}

    checks = check(cfg, xyz, rgb, wl, records, seed, device)
    compared = {k: v for k, v in checks.items() if v[1] is not None}
    correct = (bool(records) and failed == 0 and bool(compared)
               and all(math.isfinite(v) and v <= lim
                       for v, lim in compared.values()))
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=chips, memory_peak_bytes=int(peak))
    if trace:
        dev["busy_s"] = (summary or {}).get("busy_s", 0.0)
        dev["window_s"] = (summary or {}).get("window_s", window)
    result = dict(correct=correct, attempted=len(records), failed=failed,
                  metrics=metrics, device=dev)
    if breakdown:
        result["breakdown"] = breakdown
    for k, (v, lim) in checks.items():
        if lim is None:
            log(f"diagnostic {k}: {v!r}")
    result["checks"] = {k: {"value": _finite(v), "limit": lim}
                        for k, (v, lim) in compared.items()}
    return result


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def _power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    spec_doc = spec.load_spec()
    cell = spec.cell(spec_doc, args.workload)

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3
    result = run_cell(spec_doc, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    print(f"card: {_power_line()}", file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}; the port must run "
              "without JAX", file=sys.stderr)
        return 4
    checks = result["checks"]
    print("compared: " + "; ".join(
        f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()
        if v["limit"] is not None), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
