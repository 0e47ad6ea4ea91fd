#!/usr/bin/env python3
"""Check and time stage 2's splat kernel pair on one NVIDIA GPU.

    python3 scripts/bench_splat_hist.py [--ptxas] [--points N]
        [--height H --width W] [--candidates K] [--chunk C] [--out FILE.json]

At the OmniScenes cell's shapes by default (240,000 points of a ray-cast
checker room with two occluders, a 2048x1024 query, 56 candidates near its
pose, 4 x 4 blocks, chunks of 4 candidates):

  * ``check``: ``kernels/splat_hist.py``'s ``splat_block_counts`` (the pair
    ``splat_keys_kernel`` + ``dilate_block_hist_kernel``) against its
    plain PyTorch version on the card: the (K, 16, 512) block counts equal
    bit for bit, and so do ``refine.hist_scores_core``'s scores and its
    pick of the top 6;
  * ``timing``: device ms of one query's stage-2 counts
    (``chip_smoke.cuda_ms``: CUDA events, a sleep kernel queued first,
    long enough to cover the host's launches) for the pair and the plain
    version, the launches of each, and the pair's bound: the larger of its
    bytes over 3.35 TB/s (the cloud, its bins and mask, the query's
    pixel mask, each read once; the counts written once) and its
    operations over 67 TFLOP/s (``benchmark/roofline.py``'s count: 74 a
    point and candidate, 3 a pixel and candidate);
  * ``kernels``: one call under ``torch.profiler``, its device ms by
    kernel (the chunks' fills, ``splat_keys_kernel``,
    ``dilate_block_hist_kernel``) and the rotation's small ops.

``--ptxas`` first builds the source with ``-Xptxas -v`` and prints each
kernel's registers, shared memory and spills.  Needs CUDA; writes the
numbers as JSON to ``--out`` (default ``chiprun_out/bench_splat_hist.json``).
``tests/test_torch_splat_hist.py`` runs the same check on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from piccolo_tpu_torch.eval_synth import device_label  # noqa: E402
from piccolo_tpu_torch.init import refine  # noqa: E402
from piccolo_tpu_torch.kernels import _build  # noqa: E402
from piccolo_tpu_torch.kernels import splat_hist as K  # noqa: E402
from piccolo_tpu_torch.testing import (  # noqa: E402
    make_scene,
    raycast_pano,
    scene_cloud,
    scene_pose,
)

SRC = os.path.join(ROOT, "piccolo_tpu_torch", "kernels", "csrc",
                   "splat_hist.cu")
POINT_OPS = 74  # benchmark/roofline.py: a projection and a splat
PIXEL_OPS = 3  # a pixel's bin test and count
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# a sleep kernel of ~60 ms on an H100: the plain version's ~1,400 launches
# are enqueued while it runs
PLAIN_LEAD_CYCLES = 120_000_000
PAIR_LEAD_CYCLES = 20_000_000


def ptxas_report() -> str:
    """nvcc's ``-Xptxas -v`` lines for the source, built into a temp dir."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "s.so"), SRC],
            capture_output=True, text=True, timeout=600)
    return "\n".join(ln for ln in (out.stdout + out.stderr).splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln or "error" in ln)


def scene(points: int, height: int, width: int, candidates: int, dev,
          seed: int = 11):
    """A ray-cast checker room with two occluders (``testing.make_scene``),
    its query panorama from a pose inside it and ``candidates`` poses up to
    1 m and any yaw from it (pitch and roll up to 0.05 rad): a dict of
    the stage-2 inputs on ``dev``, a 90% point mask, and every 50th point
    black (the sentinel bin)."""
    rng = np.random.default_rng(seed)
    room = make_scene(rng, n_occluders=2)
    t, ypr = scene_pose(room, rng)
    xyz, rgb = scene_cloud(room, rng, points)
    rgb[::50] = 0.0
    img = torch.as_tensor(raycast_pano(room, t, ypr, (height, width)),
                          device=dev)
    ct = t + rng.uniform(-1.0, 1.0, (candidates, 3)).astype(np.float32)
    ct[:, 2] = t[2]
    cypr = np.zeros((candidates, 3), np.float32)
    cypr[:, 0] = rng.uniform(-np.pi, np.pi, candidates)
    cypr[:, 1:] = rng.uniform(-0.05, 0.05, (candidates, 2))
    return dict(
        img=img, xyz=torch.as_tensor(xyz, device=dev),
        rgb=torch.as_tensor(rgb, device=dev),
        mask=torch.as_tensor(rng.random(points) < 0.9, device=dev),
        trans=torch.as_tensor(ct, device=dev),
        ypr=torch.as_tensor(cypr, device=dev))


def counts_args(sc, sh: int, sw: int, chunk: int, masked: bool = True):
    """The arguments of ``splat_block_counts`` for the scene."""
    H, W = sc["img"].shape[:2]
    q = refine._query_side(sc["img"], sh, sw)
    bins = refine._point_bins(sc["rgb"], refine._NB)
    return (sc["xyz"], bins, sc["trans"], sc["ypr"],
            sc["mask"] if masked else None, q.pix_ok, H, W, sh, sw, chunk)


def check(sc, sh: int = 4, sw: int = 4, chunk: int = 4, masked=True):
    """The pair against the plain version: counts and the stage's scores
    equal bit for bit, its top 6 the same."""
    args = counts_args(sc, sh, sw, chunk, masked)
    n0 = K.splat_block_counts.launches
    got = K.splat_block_counts(*args)
    want = K.splat_block_counts_plain(*args)
    torch.cuda.synchronize()
    k = sc["trans"].shape[0]
    launched = K.splat_block_counts.launches - n0
    scores = refine.hist_scores_core(
        sc["img"], sc["xyz"], sc["rgb"], sc["trans"], sc["ypr"],
        sc["mask"] if masked else None, sh, sw, chunk)
    plain_scores = refine._score_from_counts(
        want, refine._query_side(sc["img"], sh, sw))
    top = torch.sort(-scores, stable=True).indices[:6]
    plain_top = torch.sort(-plain_scores, stable=True).indices[:6]
    diff = int((got != want).sum())
    return dict(shape=list(got.shape), chunk=chunk, masked=masked,
                counts_equal=diff == 0, counts_differing=diff,
                counted=float(want.sum()),
                scores_equal=bool(torch.equal(scores, plain_scores)),
                top6_equal=bool(torch.equal(top, plain_top)),
                calls=launched, chunks=-(-k // chunk),
                ok=diff == 0 and bool(torch.equal(scores, plain_scores))
                and launched == 1)


def bound_ms(points: int, height: int, width: int, k: int, nb: int):
    """(least ms, what bounds it) of the pair's work."""
    nbytes = points * (12 + 4 + 1) + height * width + k * nb * 512 * 4
    ops = k * (points * POINT_OPS + height * width * PIXEL_OPS)
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations"), b, nbytes, ops


def timing(sc, sh: int = 4, sw: int = 4, chunk: int = 4):
    args = counts_args(sc, sh, sw, chunk)
    k = sc["trans"].shape[0]
    H, W = sc["img"].shape[:2]
    (least, by), bytes_ms, nbytes, ops = bound_ms(
        sc["xyz"].shape[0], H, W, k, sh * sw)
    pair = cs.cuda_ms(lambda: K.splat_block_counts(*args),
                      lead=PAIR_LEAD_CYCLES)
    plain = cs.cuda_ms(lambda: K.splat_block_counts_plain(*args), reps=5,
                       lead=PLAIN_LEAD_CYCLES)
    return dict(pair_ms=pair, plain_ms=plain, bound_ms=least, bound_by=by,
                bytes_bound_ms=bytes_ms, bytes=nbytes, ops=ops,
                roofline_pct=100.0 * least / pair,
                launches_per_query=3 * -(-k // chunk),
                speedup=plain / pair)


def by_kernel(sc, sh: int = 4, sw: int = 4, chunk: int = 4):
    """Device ms of one call's kernels, summed by name, under
    torch.profiler (the call repeated once first)."""
    from torch.profiler import ProfilerActivity, profile

    args = counts_args(sc, sh, sw, chunk)
    K.splat_block_counts(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        K.splat_block_counts(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us:
            out[e.key[:80]] = dict(ms=us / 1e3, calls=e.count)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def run(points=240_000, height=1024, width=2048, candidates=56, chunk=4,
        ptxas=False, log=print):
    dev = torch.device("cuda")
    out = dict(device=device_label(dev), points=points,
               height=height, width=width, candidates=candidates, chunk=chunk)
    if ptxas:
        out["ptxas"] = ptxas_report()
        log(out["ptxas"])
    sc = scene(points, height, width, candidates, dev)
    out["check"] = check(sc, chunk=chunk)
    log(f"check: {json.dumps(out['check'])}")
    out["check_unmasked"] = check(sc, chunk=chunk, masked=False)
    log(f"check unmasked: {json.dumps(out['check_unmasked'])}")
    out["timing"] = timing(sc, chunk=chunk)
    log(f"timing: {json.dumps(out['timing'])}")
    out["kernels"] = by_kernel(sc, chunk=chunk)
    log(f"kernels: {json.dumps(out['kernels'])}")
    out["ok"] = out["check"]["ok"] and out["check_unmasked"]["ok"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--points", type=int, default=240_000)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--candidates", type=int, default=56)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "bench_splat_hist.json"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU (CUDA is not available)")
    out = run(a.points, a.height, a.width, a.candidates, a.chunk, a.ptxas,
              log=lambda m: print(m, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("device", "ok")}), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
