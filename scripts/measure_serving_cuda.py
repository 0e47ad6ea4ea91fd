#!/usr/bin/env python3
"""The serving measurements of the PyTorch/CUDA port, on the card.

    python3 scripts/measure_serving_cuda.py --mode MODE [flags]
        [--device cuda|cpu]

The counterpart of ``scripts/measure_serving.py`` for
``piccolo_tpu_torch``, with its modes, flags, defaults, rooms, poses,
images and JSON keys (the JAX package's records: ``docs/DEPLOY.md``
serving section, ``docs/ROUND4.md`` section 3-4, ``docs/ROUND5.md``):

  --mode http           paired HTTP request latency, default against the
                        descent-prune config: starts the real server
                        (``python -m piccolo_tpu_torch.serve``) twice on a
                        synthetic Stanford-layout room and times
                        sequential POSTs.
  --mode sustained      30 sequential library-level queries against a warm
                        room: the no-drift and no-leak check.
  --mode room-auto      room='auto' selection over 4 resident rooms (plain,
                        two same-generator checker rooms, the hard pair,
                        and a cluttered room), 3 queries each; ``--probe
                        off|on|batched``; ``--points 240000 --height
                        2048`` for the dense scale.
  --mode coldstart      the serve-level restart in ONE fresh process:
                        time to ready (load_room with its plan build and
                        warm query) and the first query.  Run it three
                        times: ``--exec-cache ''`` (off), on an empty DIR
                        (write) and on the populated DIR.
  --mode track-streams  K camera streams, each a thread of tracked
                        requests, through one room; ``--batch on|off``
                        (``track_batch``).

Rooms and query panoramas are synthesized with ``piccolo_tpu_torch.
testing``, drawn as the JAX script draws them.  The executable cache is on
by default, as in the JAX script: ``$PICCOLO_EXEC_CACHE``, else
``~/.cache/piccolo_tpu_torch/bench_exec``; ``PICCOLO_EXEC_CACHE=''``
turns it off.  The port's cache holds the built kernel libraries and the
JPEG codec (``utils.exec_cache``).  In ``coldstart`` the cache is
``--exec-cache`` alone (``''``: off), and ``fetch_init_s`` is the CUDA
context (a first allocation, synchronised).  Each JSON line adds
``device``: the card's ``nvidia-smi`` name and power limit, or ``"cpu"``.
Runs on the card; without one it raises unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from piccolo_tpu_torch.device import resolve_device  # noqa: E402
from piccolo_tpu_torch.eval_synth import device_label  # noqa: E402

SIZE = (6.0, 4.0, 3.0)
_CFG = dict(
    xy_only=True, num_trans=50, yaw_only=True, num_yaw=8, z_prior=None,
    num_split_h=4, num_split_w=4, num_intermediate=20, num_input=6,
    num_iter=100, lr=0.1, patience=5, factor=0.8,
    # the executable cache on by default, as in the JAX script;
    # PICCOLO_EXEC_CACHE='' turns it off
    exec_cache_dir=os.environ.get(
        "PICCOLO_EXEC_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "piccolo_tpu_torch",
                     "bench_exec"),
    ) or None,
)


def _make_scene(seed=3, n_per_wall=10000, texture="checker"):
    from piccolo_tpu_torch.testing import make_room

    rng = np.random.default_rng(seed)
    return make_room(rng, n_per_wall=n_per_wall, size=SIZE, texture=texture)


def _query_images(xyz, rgb, n, hw=(512, 1024), seed=9, device="cuda"):
    from piccolo_tpu_torch.testing import random_pose_inside, render_at

    rng = np.random.default_rng(seed)
    imgs = []
    for _ in range(n):
        gt_t, gt_ypr = random_pose_inside(rng, SIZE)
        imgs.append((
            (render_at(xyz, rgb, gt_t, gt_ypr, hw, device=device) * 255)
            .cpu().numpy().astype(np.uint8),
            gt_t,
        ))
    return imgs


def _service(dev, **kw):
    from piccolo_tpu_torch.serve import LocalizeService

    return LocalizeService(device=dev, **kw)


def mode_sustained(n_queries: int, dev, points: int = 60000,
                   height: int = 512):
    """``n_queries`` sequential queries over 3 images against one warm
    room; the median of the first five against the last five's."""
    hw = (height, 2 * height)
    xyz, rgb = _make_scene(n_per_wall=points // 6)
    svc = _service(dev, **_CFG)
    svc.load_room(xyz, rgb, name="box", warm_shape=hw)
    imgs = _query_images(xyz, rgb, 3, hw=hw, device=dev)
    times = []
    for i in range(n_queries):
        t0 = time.time()
        svc.localize(imgs[i % 3][0])
        times.append(time.time() - t0)
    first = sorted(times[:5])[2]
    last = sorted(times[-5:])[2]
    out = {
        "mode": "sustained", "queries": n_queries,
        "first5_median_s": round(first, 4), "last5_median_s": round(last, 4),
        "all_s": [round(t, 3) for t in times],
        "device": device_label(dev),
    }
    print(json.dumps(out), flush=True)
    return out


ROOMS = {
    "plain": (1, "plain", False),
    "checker_a": (2, "checker", False),
    "checker_b": (3, "checker", False),
    "cluttered": (4, "checker", True),
}


def make_rooms(points: int, names=tuple(ROOMS)):
    """The room-auto eval's rooms, by name: (xyz, rgb)."""
    from piccolo_tpu_torch.testing import make_cluttered_room

    npw = points // 6
    rooms = {}
    for name in names:
        seed, texture, cluttered = ROOMS[name]
        rng = np.random.default_rng(seed)
        if cluttered:
            xyz, rgb, _ = make_cluttered_room(
                rng, n_per_wall=npw, size=SIZE, texture=texture
            )
        else:
            xyz, rgb = _make_scene(seed=seed, n_per_wall=npw,
                                   texture=texture)
        rooms[name] = (xyz, rgb)
    return rooms


def room_routes(svc) -> dict:
    """Each resident room's stage-1 route: its slab plans (layout, whole or
    partial, GB), or the gather engine."""
    from piccolo_tpu_torch.harness.localize import _plan_route

    routes = {}
    for name in svc.rooms:
        cache = svc._rooms[name][0]
        n_real = cache["grids"].n_trans * int(cache["grids"].rot.shape[0])
        plans = [v for k, v in cache.items()
                 if isinstance(k, tuple) and k and k[0] == "slab_plan"]
        routes[name] = "; ".join(
            f"{_plan_route(p, None, n_real, 'loss')}, {p.nbytes / 1e9:.2f} GB"
            for p in plans) or "stage 1 gather engine"
    return routes


def mode_room_auto(dev, probe=True, points: int = 60000,
                   height: int = 512, margin=None, pairs=None,
                   names=tuple(ROOMS)):
    """The room='auto' eval, timed: the resident rooms ``names`` (the four
    by default, among them the hard same-generator checker pair), 3 auto
    queries each, plus an explicit-room baseline so the
    auto overhead is a measured ratio.  ``--probe off`` ranks by a full
    query per room; ``--points 240000 --height 2048`` runs it at the dense
    scale.  Each query's pick and each room's stage-1 route are printed on
    lines of their own."""
    hw = (height, 2 * height)
    extra = {}
    if margin is not None:
        extra["room_auto_margin"] = float(margin)
    if pairs is not None:
        extra["room_auto_probe_pairs"] = int(pairs)
    svc = _service(dev, max_rooms=4, room_auto_probe=probe, **extra, **_CFG)
    rooms = make_rooms(points, names)
    for name, (xyz, rgb) in rooms.items():
        svc.load_room(xyz, rgb, name=name)
    correct, total, errs, times = 0, 0, [], []
    for name, (xyz, rgb) in rooms.items():
        for img, gt_t in _query_images(xyz, rgb, 3, hw=hw,
                                       seed=99 + total, device=dev):
            t0 = time.time()
            out = svc.localize(img, room="auto")
            times.append(time.time() - t0)
            right = out["room"] == name
            err = float(np.linalg.norm(out["t"] - gt_t))
            scores = sorted((v, k) for k, v in out["room_scores"].items())
            print(f"query {total} in {name}: picked {out['room']}, t_err "
                  f"{err:.4f} m, {times[-1]:.3f} s; losses "
                  + ", ".join(f"{k} {v:.6g}" for v, k in scores), flush=True)
            correct += right
            total += 1
            if right:
                errs.append(err)
    # explicit-room steady-state baseline on the same service (graphs and
    # plans are warm by now): 3 queries against one known room
    base_name = "checker_a" if "checker_a" in rooms else next(iter(rooms))
    base = []
    for img, _ in _query_images(*rooms[base_name], 3, hw=hw, seed=7,
                                device=dev):
        t0 = time.time()
        svc.localize(img, room=base_name)
        base.append(time.time() - t0)
    for name, route in room_routes(svc).items():
        print(f"room {name}: {route}", flush=True)
    med_auto = float(np.median(times))
    med_base = float(np.median(base))
    out = {
        "mode": "room-auto", "probe": str(probe),
        "margin": margin, "probe_pairs": pairs,
        "points": points, "pano": [height, 2 * height],
        "correct": correct, "total": total,
        "median_t_err_m": round(float(np.median(errs)), 4) if errs else None,
        "median_auto_s": round(med_auto, 3),
        "steady_auto_s": round(float(np.median(times[4:])), 3),
        "median_single_room_s": round(med_base, 3),
        "x_single_room": round(med_auto / med_base, 2),
        "auto_s": [round(t, 3) for t in times],
        "device": device_label(dev),
    }
    print(json.dumps(out), flush=True)
    return out


def _wait_healthy(port, proc=None, timeout=600):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc is not None and proc.poll() is not None:
            return False
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=5
            ) as r:
                json.load(r)
                return True
        except Exception:
            time.sleep(2)
    return False


def mode_http(port: int, dev, requests: int = 9, points: int = 60000,
              height: int = 512):
    """Two real servers in turn, default and descent prune, each warmed at
    the query shape; the median of ``requests - 1`` sequential POSTs (the
    first decodes cold)."""
    from piccolo_tpu_torch.harness.imaging import imwrite_rgb

    hw = (height, 2 * height)
    xyz, rgb = _make_scene(n_per_wall=points // 6)
    tmp = tempfile.mkdtemp(prefix="piccolo_serve_bench_")
    pcd = os.path.join(tmp, "room.txt")
    np.savetxt(pcd, np.concatenate(
        [xyz, np.round(rgb * 255)], axis=1
    ), fmt="%.6f %.6f %.6f %d %d %d")
    img_paths = []
    for i, (img, _) in enumerate(_query_images(xyz, rgb, 3, hw=hw,
                                               device=dev)):
        p = os.path.join(tmp, f"q{i}.png")
        imwrite_rgb(p, img)
        img_paths.append(p)

    cfg = os.path.join(tmp, "cfg.ini")
    with open(cfg, "w") as f:
        f.write("[Default]\ndataset = Stanford2D-3D-S\nsample_rate = 1\n")
        f.write("".join(f"{k} = {v}\n" for k, v in _CFG.items()))

    def run_arm(label, override):
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + ":" + env.get("PYTHONPATH", "")
        cmd = [
            sys.executable, "-u", "-m", "piccolo_tpu_torch.serve",
            "--config", cfg, "--pcd", pcd, "--warm", f"{hw[0]}x{hw[1]}",
            "--port", str(port), "--device", dev.type,
        ]
        if override:
            cmd += ["--override", override]
        log = open(os.path.join(tmp, f"serve_{label}.log"), "w")
        proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=log)
        try:
            if not _wait_healthy(port, proc):
                log.flush()
                with open(log.name) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(
                    f"server never became healthy ({label}):\n{tail}")
            times = []
            for i in range(requests):
                body = json.dumps(
                    {"image_path": img_paths[i % 3]}
                ).encode()
                t0 = time.time()
                with urllib.request.urlopen(
                    urllib.request.Request(
                        f"http://127.0.0.1:{port}/localize", data=body,
                        headers={"Content-Type": "application/json"},
                    ),
                    timeout=300,
                ) as r:
                    json.load(r)
                if i > 0:  # first request per arm decodes cold
                    times.append(time.time() - t0)
            times.sort()
            return times[len(times) // 2]
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()

    default_s = run_arm("default", None)
    time.sleep(5)
    prune_s = run_arm(
        "prune", "descent_prune_iter=30,descent_prune_keep=2"
    )
    out = {
        "mode": "http", "default_median_s": round(default_s, 4),
        "prune_median_s": round(prune_s, 4),
        "speedup": round(default_s / prune_s, 2),
        "device": device_label(dev),
    }
    print(json.dumps(out), flush=True)
    return out


def mode_coldstart(exec_cache: str, points: int, height: int, dev):
    """Serve-level restart cost: time to ready (the service, whose
    executable cache builds or loads the libraries, then load_room with
    its plan build and warm query) and the first real query, in ONE fresh
    process.  The cache is ``exec_cache`` alone: ``''`` runs with none.
    ``warm`` gives the cache's hits, builds and seconds (None when off);
    ``store`` what the process's library store loaded and built by the
    first answer (with no cache, the default ``kernels/_build/``)."""
    from piccolo_tpu_torch.kernels import _build

    # the CUDA context, on a 1-element tensor, reported separately
    t0 = time.time()
    torch.zeros((1,), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fetch_init_s = time.time() - t0

    xyz, rgb = _make_scene(seed=3, n_per_wall=points // 6)
    cfg = dict(_CFG)
    cfg["exec_cache_dir"] = exec_cache or None
    t0 = time.time()
    svc = _service(dev, slab_background_build=False, **cfg)
    svc.load_room(xyz, rgb, name="dense", warm_shape=(height, 2 * height))
    ready_s = time.time() - t0
    img, gt_t = _query_images(xyz, rgb, 1, hw=(height, 2 * height),
                              seed=21, device=dev)[0]
    t0 = time.time()
    out = svc.localize(img)
    first_s = time.time() - t0
    warm = svc.exec_cache
    store = _build.library_store()
    res = {
        "mode": "coldstart", "exec_cache": bool(exec_cache),
        "points": points, "pano": [height, 2 * height],
        "fetch_init_s": round(fetch_init_s, 1),
        "ready_s": round(ready_s, 2),
        "first_query_s": round(first_s, 2),
        "t_err_m": round(float(np.linalg.norm(out["t"] - gt_t)), 4),
        "warm": None if warm is None else dict(
            hits=list(warm["hits"]), built=list(warm["built"]),
            seconds=round(warm["seconds"], 3)),
        "store": dict(dir=str(store.path), hits=sorted(set(store.hits)),
                      built=sorted(set(store.built_names))),
        "device": device_label(dev),
    }
    print(json.dumps(res), flush=True)
    return res


def mode_track_streams(k: int, frames: int, batch: bool, points: int,
                       height: int, dev):
    """K camera streams track smooth trajectories through ONE room on one
    card, each stream a free-running thread of serving requests.  With
    ``track_batch`` on, requests that pile up behind the card drain as one
    batched descent (``serve._track_room_maybe_batched``); ``--batch off``
    is the strict per-request baseline.  Reports per-request latency
    percentiles, the aggregate frame rate, the realised batch-size
    histogram, and accuracy against the streams' ground-truth poses."""
    import threading

    from piccolo_tpu_torch.testing import render_at
    from piccolo_tpu_torch.tracking import ypr_from_rot

    hw = (height, 2 * height)
    xyz, rgb = _make_scene(seed=3, n_per_wall=points // 6)
    svc = _service(dev, track_batch=batch, max_pending=2 * k, **_CFG)
    svc.load_room(xyz, rgb, name="box", warm_shape=hw)

    # per-stream smooth trajectories (~3 cm / ~1.1 deg per frame), frames
    # rendered up front so the drive times serving, not the oracle
    rng = np.random.default_rng(11)
    streams = []
    for s in range(k):
        t0 = np.float32([rng.uniform(-1.5, 1.5), rng.uniform(-1.0, 1.0),
                         rng.uniform(-0.5, 0.5)])
        yaw0 = rng.uniform(-np.pi, np.pi)
        step = np.float32([rng.uniform(-0.03, 0.03),
                           rng.uniform(-0.03, 0.03), 0.01])
        gts, imgs = [], []
        for f in range(frames + 1):
            t = t0 + f * step
            ypr = np.float32([yaw0 + 0.02 * f, 0.0, 0.0])
            gts.append((t, ypr))
            imgs.append((render_at(xyz, rgb, t, ypr, hw, device=dev) * 255)
                        .cpu().numpy().astype(np.uint8))
        streams.append((gts, imgs))

    # seed each stream with one full query on its frame 0
    poses = []
    for gts, imgs in streams:
        out = svc.localize(imgs[0])
        poses.append({"t": out["t"].tolist(),
                      "ypr": ypr_from_rot(out["rot"]).tolist()})

    def drive(record):
        lat = [[] for _ in range(k)]
        errs, hist = [], {}
        t_wall = time.time()

        def run_stream(s):
            gts, imgs = streams[s]
            prev = dict(poses[s])
            for f in range(1, frames + 1):
                t0 = time.time()
                out = svc.localize(imgs[f], prev_pose=prev)
                lat[s].append(time.time() - t0)
                prev = {"t": out["t"].tolist(), "ypr": out["ypr"].tolist()}
                b = int(out.get("batched", 1))
                hist[b] = hist.get(b, 0) + 1
                errs.append(float(np.linalg.norm(out["t"] - gts[f][0])))

        threads = [threading.Thread(target=run_stream, args=(s,))
                   for s in range(k)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.time() - t_wall
        if not record:
            return None
        flat = sorted(x for per in lat for x in per)
        return dict(
            wall_s=round(wall, 3),
            agg_fps=round(k * frames / wall, 2),
            lat_p50_s=round(flat[len(flat) // 2], 4),
            lat_p90_s=round(flat[int(len(flat) * 0.9)], 4),
            batch_hist={str(b): n for b, n in sorted(hist.items())},
            median_t_err_m=round(float(np.median(errs)), 4),
            max_t_err_m=round(float(np.max(errs)), 4),
        )

    drive(record=False)  # warm-up: captures whichever batch shapes occur
    measured = drive(record=True)

    # single-stream steady baseline on the same warm service
    gts, imgs = streams[0]
    prev = dict(poses[0])
    single = []
    for f in range(1, frames + 1):
        t0 = time.time()
        out = svc.localize(imgs[f], prev_pose=prev)
        single.append(time.time() - t0)
        prev = {"t": out["t"].tolist(), "ypr": out["ypr"].tolist()}
    res = {
        "mode": "track-streams", "batch": batch, "streams": k,
        "frames_per_stream": frames, "points": points, "pano": list(hw),
        **measured,
        "single_stream_median_s": round(float(np.median(single)), 4),
        "x_single_stream": round(
            measured["lat_p50_s"] / float(np.median(single)), 2
        ),
        "device": device_label(dev),
    }
    print(json.dumps(res), flush=True)
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode",
                    choices=("http", "sustained", "room-auto", "coldstart",
                             "track-streams"),
                    default="sustained")
    ap.add_argument("--queries", type=int, default=30,
                    help="query count for --mode sustained")
    ap.add_argument("--port", type=int, default=8341)
    ap.add_argument("--probe", choices=("on", "off", "batched"),
                    default="on",
                    help="room-auto probe phase: off = a full query per "
                         "room, on = the per-room probe, batched = one "
                         "probe program over all rooms")
    ap.add_argument("--margin", type=float, default=None,
                    help="--mode room-auto: override room_auto_margin "
                         "(probe-loss finalist cut, default 3.0)")
    ap.add_argument("--probe-pairs", type=int, default=None,
                    help="--mode room-auto: override room_auto_probe_pairs "
                         "(per-room stage-1 pair budget, default 512)")
    ap.add_argument("--exec-cache", default="",
                    help="--mode coldstart: executable cache dir ('' = off)")
    ap.add_argument("--points", type=int, default=None,
                    help="room point count (coldstart default 240000; "
                         "room-auto default 60000; pass 240000 for the "
                         "dense-scale probe measurement)")
    ap.add_argument("--height", type=int, default=None,
                    help="pano height, W = 2H (coldstart default 1024; "
                         "room-auto default 512)")
    ap.add_argument("--streams", type=int, default=6,
                    help="--mode track-streams: concurrent camera streams")
    ap.add_argument("--frames", type=int, default=12,
                    help="--mode track-streams: tracked frames per stream")
    ap.add_argument("--batch", choices=("on", "off"), default="on",
                    help="--mode track-streams: serving micro-batch on/off")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.mode == "http":
        return mode_http(args.port, dev)
    if args.mode == "room-auto":
        return mode_room_auto(
            dev,
            probe={"on": True, "off": False,
                   "batched": "batched"}[args.probe],
            points=args.points or 60000,
            height=args.height or 512,
            margin=args.margin, pairs=args.probe_pairs)
    if args.mode == "coldstart":
        return mode_coldstart(args.exec_cache, args.points or 240000,
                              args.height or 1024, dev)
    if args.mode == "track-streams":
        return mode_track_streams(args.streams, args.frames,
                                  batch=args.batch == "on",
                                  points=args.points or 60000,
                                  height=args.height or 512, dev=dev)
    return mode_sustained(args.queries, dev)


if __name__ == "__main__":
    main()
