"""Served throughput under concurrent clients, taken apart, on the card.

    python3 scripts/served_concurrency.py [--clients 4] [--rounds 2]
        [--replicas 4]

Writes a ray-cast Stanford tree (one room of 60,000 points, four 1024x512
panoramas) into a temporary directory and serves its room with
``piccolo_tpu_torch.serve.LocalizeService`` under configs/stanford.ini as
shipped and with ``sharpen_color=False``, in three layouts:

* ``one card``: one replica under one compute lock;
* ``R replicas on one card``: R replicas of the room on cuda:0, each under
  its own compute lock: the host side of ``query_devices`` (R threads
  dispatching at once) without a second card;
* ``query_devices=all``, when two or more cards are visible.

Each layout first answers the panoramas one at a time (``time_s`` alone),
then ``--clients`` threads send ``--rounds`` passes over the panoramas at
once.  Reported per layout: requests/s, ``total_s`` p50, ``time_s`` (the
compute under the lock) p50 alone and under load, each client thread's host
CPU seconds (``time.thread_time``) and the load's wall seconds, and
``time_s`` summed by replica.  One JSON line on stdout, also written to
``chiprun_out/served_concurrency.json``.

``--blocking-sync`` first sets every card's primary context to block the
host thread while it waits for the card (``CU_CTX_SCHED_BLOCKING_SYNC``)
instead of the default, which spins when the cards are fewer than the
host's cores.

``--launch-probe`` instead times launches alone: threads that each launch
a tiny in-place add (no allocation) and a tiny out-of-place add (one
allocation) ``--launches`` times on a 4-float tensor, as 1 thread on
cuda:0, 4 threads on cuda:0 and, with four cards, 4 threads on 4 cards:
launches/s in all and each thread's host CPU seconds.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CONFIG = os.path.join(REPO, "configs", "stanford.ini")


def blocking_sync():
    """Every card's primary context blocks on a wait instead of spinning
    (the driver API; the return codes are printed)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    codes = [cu.cuInit(0)]
    for i in range(torch.cuda.device_count()):
        dev = ctypes.c_int()
        codes.append(cu.cuDeviceGet(ctypes.byref(dev), i))
        codes.append(cu.cuDevicePrimaryCtxSetFlags(dev, 0x4))
    print(f"blocking sync: driver return codes {codes}", flush=True)
    if any(codes):
        sys.exit("served_concurrency: could not set blocking sync")


def launch_probe(devices, launches):
    """One thread a device in ``devices``, each launching ``launches``
    tiny adds in place and as many out of place; launches/s in all and each
    thread's host CPU seconds, by kind."""
    out = {}
    for kind in ("in place", "out of place"):
        cpu, ready = {}, threading.Barrier(len(devices) + 1)

        def run(k, dev):
            with torch.cuda.device(dev):
                x = torch.zeros(4, device=dev)
                x.add_(1)
                torch.cuda.synchronize(dev)
                ready.wait()
                c0 = time.thread_time()
                for _ in range(launches):
                    if kind == "in place":
                        x.add_(1)
                    else:
                        x = x + 1
                torch.cuda.synchronize(dev)
                cpu[k] = time.thread_time() - c0

        threads = [threading.Thread(target=run, args=(k, d))
                   for k, d in enumerate(devices)]
        for th in threads:
            th.start()
        ready.wait()
        t0 = time.time()
        for th in threads:
            th.join()
        wall = time.time() - t0
        out[kind] = dict(launches_per_s=len(devices) * launches / wall,
                         thread_host_cpu_s=[cpu[k] for k in sorted(cpu)])
    return out


def serve_layout(make, xyz, rgb, images, clients, rounds):
    svc = make()
    svc.load_room(xyz, rgb, name="office_1", warm_shape=(512, 1024))
    alone = [svc.localize(img)["time_s"] for img in images]
    errors = []
    host, by_replica, totals, held = {}, {}, [], []
    lock = threading.Lock()

    def client(k):
        c0 = time.thread_time()
        try:
            for j in range(rounds * len(images)):
                got = svc.localize(images[(k + j) % len(images)])
                with lock:
                    totals.append(got["total_s"])
                    held.append(got["time_s"])
                    i = got["device_index"]
                    by_replica[i] = by_replica.get(i, 0.0) + got["time_s"]
        except Exception as exc:  # reported below
            errors.append(exc)
        host[k] = time.thread_time() - c0

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.time()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.time() - t0
    if errors:
        raise errors[0]
    out = dict(requests_per_s=len(totals) / wall, wall_s=wall,
               total_s_p50=float(np.median(totals)),
               time_s_alone_p50=float(np.median(alone)),
               time_s_loaded_p50=float(np.median(held)),
               thread_host_cpu_s=[host[k] for k in sorted(host)],
               time_s_by_replica={str(k): by_replica[k]
                                  for k in sorted(by_replica)},
               replicas=svc.devices)
    del svc
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--blocking-sync", action="store_true")
    ap.add_argument("--launch-probe", action="store_true")
    ap.add_argument("--launches", type=int, default=20000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("served_concurrency: CUDA is not available")
    if args.blocking_sync:
        blocking_sync()
    if args.launch_probe:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        layouts = {"1 thread on cuda:0": cards[:1],
                   "4 threads on cuda:0": cards[:1] * 4}
        if len(cards) >= 4:
            layouts["4 threads on 4 cards"] = cards[:4]
        result = dict(card=torch.cuda.get_device_name(0),
                      visible=len(cards), launches=args.launches,
                      launch_probe={k: launch_probe(v, args.launches)
                                    for k, v in layouts.items()})
        print(json.dumps(result), flush=True)
        return
    from piccolo_tpu_torch.config import apply_overrides, parse_ini
    from piccolo_tpu_torch.data import read_stanford
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.serve import LocalizeService
    from piccolo_tpu_torch.testing import write_synth_stanford

    class OneCardReplicas(LocalizeService):
        """query_devices' replicas and locks, every replica on cuda:0."""

        def _resolve_query_devices(self, cfg, dev):
            return [dev] * args.replicas

    tmp = tempfile.mkdtemp(prefix="piccolo_served_")
    try:
        tree = os.path.join(tmp, "data")
        write_synth_stanford(tree, rooms=1, queries=4, points=60000,
                             height=512, seed=7, oracle="raycast")
        xyz, rgb = (a.astype(np.float32) for a in read_stanford(os.path.join(
            tree, "stanford", "pcd_not_aligned", "area_1", "office_1.txt"), 1))
        images = [imread_rgb(p) for p in sorted(glob.glob(os.path.join(
            tree, "stanford", "pano", "area_1", "*.png")))]
        dev = torch.device("cuda", 0)
        result = dict(card=torch.cuda.get_device_name(0),
                      visible=torch.cuda.device_count(),
                      clients=args.clients, rounds=args.rounds,
                      blocking_sync=args.blocking_sync, layouts={})
        for extra in ("", "sharpen_color=False"):
            def cfg(ov=""):
                ovs = ",".join(x for x in (ov, extra) if x)
                base = parse_ini(CONFIG)
                return apply_overrides(base, ovs) if ovs else base

            layouts = [("one card", lambda: LocalizeService(cfg(), device=dev)),
                       (f"{args.replicas} replicas on one card",
                        lambda: OneCardReplicas(cfg(), device=dev))]
            if torch.cuda.device_count() >= 2:
                layouts.append(("query_devices=all", lambda: LocalizeService(
                    cfg("query_devices=all"), device=dev)))
            for label, make in layouts:
                key = f"{label}{', ' + extra if extra else ''}"
                got = serve_layout(make, xyz, rgb, images, args.clients,
                                   args.rounds)
                result["layouts"][key] = got
                print(f"{key}: {json.dumps(got)}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    name = "served_concurrency" + ("_blocking" if args.blocking_sync else "")
    with open(os.path.join(REPO, "chiprun_out", name + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
