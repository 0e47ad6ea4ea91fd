#!/usr/bin/env python3
"""Check and time the descent's step kernels on one NVIDIA GPU.

    python3 scripts/bench_descent_step.py [--ptxas] [--points N]
        [--height H --width W] [--starts S] [--streams K] [--iters I]
        [--out FILE.json]

At the OmniScenes cell's shapes by default (240,000 points of a ray-cast
checker room with two occluders, dense 2048x1024 panoramas, 6 starts
around the pose, 3 stacked streams for tracked frames):

  * ``checks``: the kernel pair (``kernels/descent_step.py``) against its
    plain PyTorch version on the card, for f32, bf16 and uint8 tables, with
    and without the seam's wrap, masked and unmasked, S starts on one table
    and K streams stacked through ``row_offset``: the valid count exact,
    the distance total within ``TOTAL_RTOL``, sum g and sum g c^T within
    ``SUM_RTOL`` of their largest component, and one whole step's pose
    within ``POSE_ATOL``, moments within ``MOMENT_RTOL`` and loss within
    ``TOTAL_RTOL`` of the plain step's, its integer state and learning
    rate equal;
  * ``replays``: two replays of the captured step from one state give the
    same bits;
  * ``descent``: the cell's S x ``--iters`` descent (bf16 table) through the
    solver's graph against the plain version's loop, the autograd step's
    eager loop, and the autograd step one start at a time (the witness:
    the batch's reduction order alone), from starts up to 0.1 m and 0.15
    rad off (``NEAR``) and from starts up to 0.3 m and 0.4 rad off
    (``FAR``); from the near starts each start ends within twice the
    witness's widest gap + ``GAP_FLOOR_M`` (at most ``GAP_CAP_M``) of the
    autograd step, the picks' losses within ``BEST_LOSS_RTOL`` and both
    picks within ``PICK_FROM_POSE_M`` of the pose;
  * ``timing``: device ms of one step (``chip_smoke.cuda_ms``: CUDA events,
    a sleep kernel queued first) for the kernel pair's captured graph, the
    same graph of the autograd step (the step before the kernels), the
    plain version, and the bound: bytes over 3.35 TB/s or operations over
    67 TFLOP/s, the larger (bytes: the cloud once, one texel row a
    start-point, the partials; operations: 255 a start-point, the
    benchmark's count for the descent).

``--ptxas`` first builds the source with ``-Xptxas -v`` and prints each
kernel's registers, shared memory and spills.  Needs CUDA; writes the
numbers as JSON to ``--out`` (default ``chiprun_out/bench_descent_step.json``).
``tests/test_torch_cuda.py`` runs the same checks, with these bounds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from piccolo_tpu_torch import solver  # noqa: E402
from piccolo_tpu_torch.kernels import _build  # noqa: E402
from piccolo_tpu_torch.kernels import descent_step as K  # noqa: E402
from piccolo_tpu_torch.optim import init_adam_plateau  # noqa: E402
from piccolo_tpu_torch.loss import Pose  # noqa: E402
from piccolo_tpu_torch.testing import (  # noqa: E402
    make_scene,
    raycast_pano,
    scene_cloud,
    scene_pose,
)

SRC = os.path.join(ROOT, "piccolo_tpu_torch", "kernels", "csrc",
                   "descent_step.cu")
OPS_PER_START_POINT = 255  # benchmark/roofline.py's descent count
# the bounds of the checks
TOTAL_RTOL = 1e-5  # the distance total and a step's loss
SUM_RTOL = 1e-4  # sum g and sum g c^T, of their largest component
POSE_ATOL = 1e-4  # a step's pose leaves
MOMENT_RTOL = 1e-4  # a step's Adam moments, of their largest component
NEAR, FAR = (0.1, 0.15), (0.3, 0.4)  # starts' spread: m, rad of yaw
GAP_FLOOR_M, GAP_CAP_M = 2e-3, 0.025
BEST_LOSS_RTOL = 0.1
PICK_FROM_POSE_M = 0.02


def ptxas_report() -> str:
    """nvcc's ``-Xptxas -v`` lines for the source, built into a temp dir."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "d.so"), SRC],
            capture_output=True, text=True, timeout=600)
    return "\n".join(ln for ln in (out.stdout + out.stderr).splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln or "error" in ln)


def scene(points: int, height: int, width: int, streams: int, dev):
    """A ray-cast checker room with two occluders (``testing.make_scene``):
    (cloud xyz, rgb, a 90% mask, K dense panoramas from poses 3 cm and 0.02
    rad apart, the clamp box lo, hi, the first panorama's pose (t, ypr))."""
    rng = np.random.default_rng(11)
    room = make_scene(rng, n_occluders=2)
    t, ypr = scene_pose(room, rng)
    xyz, rgb = scene_cloud(room, rng, points)
    imgs = torch.stack([torch.as_tensor(raycast_pano(
        room, t + np.float32([0.03 * k, 0.0, 0.0]),
        ypr + np.float32([0.02 * k, 0, 0]), (height, width)), device=dev)
        for k in range(streams)])
    xyz_d = torch.as_tensor(xyz, device=dev)
    rgb_d = torch.as_tensor(rgb, device=dev)
    mask = torch.as_tensor(rng.random(xyz.shape[0]) < 0.9, device=dev)
    lo = torch.tensor([-2.8, -1.8, -1.3], device=dev)
    hi = torch.tensor([2.8, 1.8, 1.3], device=dev)
    return (xyz_d, rgb_d, mask, imgs, lo, hi,
            (t.astype(np.float32), ypr.astype(np.float32)))


def starts(sc, S: int, spread=FAR, seed: int = 3):
    """S starts up to spread[0] m and spread[1] rad (yaw) from the pose."""
    rng = np.random.default_rng(seed)
    gt_t, gt_ypr = sc[-1]
    dev = sc[0].device
    t = gt_t + rng.uniform(-spread[0], spread[0], (S, 3)).astype(np.float32)
    ypr = np.zeros((S, 3), np.float32)
    ypr[:, 0] = gt_ypr[0] + rng.uniform(-spread[1], spread[1], S)
    ypr[:, 1:] = rng.uniform(-0.05, 0.05, (S, 2))
    return torch.as_tensor(t, device=dev), torch.as_tensor(ypr, device=dev)


def inputs(sc, dtype: str, wrap: bool, masked: bool, stacked: int):
    """StepInputs and statics: one table, or ``stacked`` tables."""
    xyz, rgb, mask, imgs, lo, hi, _ = sc
    H, W = imgs.shape[1:3]
    k = max(stacked, 1)
    blocks = torch.cat([solver._packed_table(imgs[i], dtype, wrap)
                        for i in range(k)])
    offset = None
    if stacked:
        offset = (torch.arange(k, dtype=torch.int32, device=xyz.device)
                  * ((H + 1) * (W + 1)))[:, None]
    x = solver.StepInputs(blocks, xyz, rgb, mask if masked else None, lo, hi,
                          offset)
    return x, solver.StepStatics(H, W, 5, 0.9, wrap)


def leaves_at(t, ypr, lr=0.1):
    params = Pose(t=t.clone(), yaw=ypr[:, 0].clone(),
                  pitch=ypr[:, 1].clone(), roll=ypr[:, 2].clone())
    return solver._contiguous(solver._state_leaves(
        params, init_adam_plateau(params, lr)))


def _rel(a, b):
    """Largest |a - b| over the largest |b| of each row group."""
    scale = b.abs().max().clamp_min(1e-30)
    return float((a - b).abs().max() / scale)


def check_case(sc, dtype, wrap, masked, S, stacked):
    """The pair against the plain version: the sums of S starts (or of
    ``stacked`` streams), one whole step in place, then ten more steps
    each; a dict of the gaps with ``ok``."""
    x, s = inputs(sc, dtype, wrap, masked, stacked)
    t, ypr = starts(sc, S)
    leaves = leaves_at(t, ypr)
    partials = K.scratch(x.xyz.shape[0], S, t.device)
    got = K.descent_partials(x, s, leaves, partials).sum(-1)
    want = K.partials_plain(x, s, *leaves[0:4])
    row = dict(table=dtype, wrap=wrap, masked=masked, starts=S,
               stacked=bool(stacked),
               count_equal=bool(torch.equal(got[:, 1], want[:, 1])),
               count_diff=int((got[:, 1] - want[:, 1]).abs().max()),
               total_rel=float(((got[:, 0] - want[:, 0]).abs()
                                / want[:, 0].abs().clamp_min(1e-30)).max()),
               sum_g_rel=_rel(got[:, 2:5], want[:, 2:5]),
               sum_gc_rel=_rel(got[:, 5:], want[:, 5:]))
    loss = torch.empty_like(leaves[1])
    kern = [a.clone() for a in leaves]
    K.descent_step(x, s, kern, loss, partials)
    plain, plain_loss = K.descent_step_plain(x, s, leaves)
    row["step_pose_diff"] = max(float((a - b).abs().max())
                                for a, b in zip(kern[0:4], plain[0:4]))
    row["step_moment_rel"] = max(_rel(a, b) for a, b in zip(kern[4:12],
                                                            plain[4:12]))
    row["step_loss_rel"] = float(((loss - plain_loss).abs()
                                  / plain_loss.abs()).max())
    row["step_rest_equal"] = all(torch.equal(kern[i], plain[i])
                                 for i in (12, 13, 15))
    # ten more steps each, from the same state
    for _ in range(10):
        K.descent_step(x, s, kern, loss, partials)
        plain, plain_loss = K.descent_step_plain(x, s, plain)
    row["step11_pose_diff"] = max(float((a - b).abs().max())
                                  for a, b in zip(kern[0:4], plain[0:4]))
    row["ok"] = (row["count_equal"] and row["total_rel"] < TOTAL_RTOL
                 and row["sum_g_rel"] < SUM_RTOL
                 and row["sum_gc_rel"] < SUM_RTOL
                 and row["step_pose_diff"] < POSE_ATOL
                 and row["step_moment_rel"] < MOMENT_RTOL
                 and row["step_loss_rel"] < TOTAL_RTOL
                 and row["step_rest_equal"])
    return row


def graph_of(sc, x, s, S, autograd: bool):
    """The solver's captured step for (x, s) at S starts, the kernel pair's
    or (``autograd``) the autograd step's."""
    t, ypr = starts(sc, S)
    params = Pose(t=t, yaw=ypr[:, 0], pitch=ypr[:, 1], roll=ypr[:, 2])
    state = init_adam_plateau(params, 0.1)
    key = ("bench", autograd, id(x))
    if autograd:
        with mock.patch.object(solver.kstep, "engages", lambda *a: False):
            return solver._StepGraph(key, x, s, params, state), params, state
    return solver._StepGraph(key, x, s, params, state), params, state


def replays(sc, S):
    """Whether the kernel pair's captured step, run twice for 3 steps from
    one state, gives the same bits."""
    x, s = inputs(sc, "bfloat16", False, True, 0)
    g, params, state = graph_of(sc, x, s, S, False)
    outs = []
    for _ in range(2):
        p, st, loss, _ = g.run(x, params, state, 3, False)
        torch.cuda.synchronize()
        outs.append([*solver._state_leaves(p, st), loss])
    return g.kernel and all(torch.equal(a, b) for a, b in zip(*outs))


def _gaps(a, b):
    """Per-start |t_a - t_b| (m) and the relative loss gap."""
    return ([round(float(g), 6) for g in (a[0] - b[0]).norm(dim=1)],
            [round(float(g), 6) for g in ((a[1] - b[1]).abs() / b[1].abs())])


def descent(sc, S, iters, spread):
    """The solver's graphed descent (the kernels) from S starts against
    the plain version's loop, the autograd step's eager loop, and the
    autograd step run one start at a time (the batch's reduction order:
    the witness of how far ulps carry); bf16 table, masked cloud.  ``ok``
    holds the near starts' bounds (module docstring)."""
    x, s = inputs(sc, "bfloat16", False, True, 0)
    t, ypr = starts(sc, S, spread)
    p, loss, _, _ = solver.descend_packed(x, s, t, ypr, iters, 0.1)
    kern = (p.t, loss)
    leaves = leaves_at(t, ypr)
    for _ in range(iters):
        leaves, plain_loss = K.descent_step_plain(x, s, leaves)
    plain = (leaves[0], plain_loss)

    def autograd(t, ypr):
        params = Pose(t=t.clone(), yaw=ypr[:, 0].clone(),
                      pitch=ypr[:, 1].clone(), roll=ypr[:, 2].clone())
        state = init_adam_plateau(params, 0.1)
        step = solver._make_step(x, s)
        for _ in range(iters):
            params, state, loss = step(params, state)
        return params.t, loss

    auto = autograd(t, ypr)
    singles = [autograd(t[i:i + 1], ypr[i:i + 1]) for i in range(S)]
    alone = (torch.cat([a[0] for a in singles]),
             torch.cat([a[1] for a in singles]))
    torch.cuda.synchronize()
    out = dict(spread=spread, kernel_loss=kern[1].tolist(),
               autograd_loss=auto[1].tolist())
    for name, (a, b) in dict(kernel_vs_plain=(kern, plain),
                             kernel_vs_autograd=(kern, auto),
                             autograd_batch_vs_alone=(auto, alone)).items():
        out[name] = dict(zip(("t_gap_m", "loss_rel"), _gaps(a, b)),
                         picks=(int(torch.argmin(a[1])),
                                int(torch.argmin(b[1]))),
                         best_loss_rel=float(a[1].min() / b[1].min() - 1))
    gt = torch.as_tensor(sc[-1][0], device=t.device)
    ka, kb = out["kernel_vs_autograd"]["picks"]
    out["picks_from_pose_m"] = [float((kern[0][ka] - gt).norm()),
                                float((auto[0][kb] - gt).norm())]
    witness = max(out["autograd_batch_vs_alone"]["t_gap_m"])
    out["ok"] = (
        max(out["kernel_vs_autograd"]["t_gap_m"])
        <= min(2 * witness + GAP_FLOOR_M, GAP_CAP_M)
        and abs(float(kern[1][ka]) / float(auto[1][kb]) - 1) < BEST_LOSS_RTOL
        and max(out["picks_from_pose_m"]) < PICK_FROM_POSE_M)
    return out


def bound_ms(N, S, table_bytes_per_row):
    nbytes = N * (12 + 12 + 1) + S * N * table_bytes_per_row
    return cs._bound(nbytes, S * N * OPS_PER_START_POINT)


def timing(sc, S, stacked):
    x, s = inputs(sc, "bfloat16", False, True, stacked)
    S = stacked or S
    new, _, _ = graph_of(sc, x, s, S, False)
    old, _, _ = graph_of(sc, x, s, S, True)
    t, ypr = starts(sc, S)
    leaves = leaves_at(t, ypr)
    N = x.xyz.shape[0]
    b, by = bound_ms(N, S, 24)
    new_ms, old_ms = cs.cuda_ms(new.graph.replay), cs.cuda_ms(old.graph.replay)
    return dict(starts=S, stacked=bool(stacked), points=N,
                kernel_graph_ms=new_ms, autograd_graph_ms=old_ms,
                plain_ms=cs.cuda_ms(lambda: K.descent_step_plain(x, s, leaves),
                                    reps=5),
                bound_ms=b, bound_by=by, share_of_bound=b / new_ms,
                speedup=old_ms / new_ms)


def measure(points=240_000, height=1024, width=2048, n_starts=6, streams=3,
            iters=100, ptxas=False, log=print):
    """Every check and timing above, as a dict with ``ok``."""
    dev = torch.device("cuda")
    out = dict(device=cs.phase_device())
    if ptxas:
        out["ptxas"] = ptxas_report()
        log(out["ptxas"])
    sc = scene(points, height, width, streams, dev)
    out["checks"] = []
    for dtype in ("float32", "bfloat16", "uint8"):
        for wrap in (False, True):
            for masked in (False, True):
                for S, stacked in ((n_starts, 0), (1, 0), (streams, streams)):
                    out["checks"].append(
                        check_case(sc, dtype, wrap, masked, S, stacked))
    bad = [r for r in out["checks"] if not r["ok"]]
    log(f"descent step checks: {len(out['checks']) - len(bad)} of "
        f"{len(out['checks'])} within their bounds" +
        "".join("\n" + json.dumps(r) for r in bad))
    out["replays_equal"] = replays(sc, n_starts)
    out["descent"] = [descent(sc, n_starts, iters, spread)
                      for spread in (NEAR, FAR)]
    for row in out["descent"]:
        log(json.dumps(row))
    out["descent_ok"] = out["descent"][0]["ok"]
    out["timing"] = [timing(sc, n_starts, 0), timing(sc, n_starts, streams)]
    for row in out["timing"]:
        log(json.dumps(row))
    out["ok"] = (not bad and out["replays_equal"] and out["descent_ok"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--points", type=int, default=240_000)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--starts", type=int, default=6)
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--out", default="chiprun_out/bench_descent_step.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_descent_step: needs CUDA")
    out = measure(a.points, a.height, a.width, a.starts, a.streams, a.iters,
                  a.ptxas, log=lambda m: print(m, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(dict(ok=out["ok"], replays_equal=out["replays_equal"],
                          descent_ok=out["descent_ok"])))
    if not out["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
