"""``correct`` comes out false for the control and for each fault the
cells can have, at a size the CPU holds.

The control is the plain reference computed in bfloat16 (the precision
below the configuration's float32) put in the program's place.  The faults
are planted in the program underneath a whole run: a descent whose steps
return their state unchanged, an answer altered where it is produced, and
a batch of tracked frames that computes half its rows.  The cells' runs
cross no card, so no exchange between cards can be left out.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import calibrate, judge, reference, run, spec
from benchmark.tests import tiny

SEED = 21


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def control_root(tmp_path_factory):
    """bfloat16 moves a pose by a share of its size, which a 32 x 64 image
    cannot see; the control is read at 256 x 512."""
    return tiny.make(tmp_path_factory.mktemp("bench_control"), (256, 512),
                     12000)


def test_sound_runs_are_correct(root):
    for w in ("omniscenes.query", "omniscenes.track"):
        assert tiny.run(root, w, SEED)["correct"], w


def _control_reading(root, workload):
    doc = spec.load_spec(root)
    cell = spec.cell(doc, workload)
    cfg = spec.load_config(doc, cell["config"], root)
    mix = spec.load_traffic(cell["traffic"], root / "benchmark")
    xyz, rgb, wl = run.build(cfg, mix, SEED, "cpu")
    room = reference.Room(xyz, rgb, dict(cfg["ini"], **cfg["program"]),
                          "cpu")
    if wl.kind == "query":
        imgs = {i: wl.images[i] for i in range(2)}
        return judge.judge_queries(
            room, imgs, [], answer_fn=lambda img: room.localize(
                img, torch.bfloat16))["regret"]
    frames = []
    for s in wl.streams[:2]:
        t, R = wl.gt[s[0]]
        frames.append(dict(img=wl.images[s[1]], image_key=s[1],
                           prev={"t": t.tolist(), "ypr": list(
                               reference.ypr_of(R))}))
    return judge.judge_tracked(room, frames, answer_fn=lambda fr, m, c: (
        room.track(fr["img"], fr["prev"]["t"], fr["prev"]["ypr"],
                   torch.bfloat16, main=m, rgb=c)))["regret"]


@pytest.mark.parametrize("workload", ["omniscenes.query", "omniscenes.track"])
def test_the_control_is_not_correct(control_root, workload):
    key = "query_regret" if workload.endswith("query") else "track_regret"
    assert _control_reading(control_root, workload) > tiny.LIMITS[key]


def _shift(t):
    return np.asarray(t, np.float32) + np.float32([0.5, 0.0, 0.0])


def _unchanged_query(monkeypatch):
    from piccolo_tpu_torch import pipeline
    from piccolo_tpu_torch.loss import Pose

    real = pipeline.descend_starts

    def still(img, xyz, rgb, t0s, ypr0s, *a, **k):
        params, losses, lrs, traj = real(img, xyz, rgb, t0s, ypr0s, *a, **k)
        return (Pose(t0s.clone(), ypr0s[:, 0].clone(), ypr0s[:, 1].clone(),
                     ypr0s[:, 2].clone()), losses, lrs, traj)

    monkeypatch.setattr(pipeline, "descend_starts", still)


def _altered_query(monkeypatch):
    from piccolo_tpu_torch.serve import LocalizeService

    real = LocalizeService._compute_room

    def altered(self, *a, **k):
        out = real(self, *a, **k)
        out["t"] = _shift(out["t"])
        return out

    monkeypatch.setattr(LocalizeService, "_compute_room", altered)


def _unchanged_track(monkeypatch):
    from piccolo_tpu_torch import tracking

    def still_one(img, xyz, rgb, t, ypr, *a, **k):
        yt = torch.as_tensor(np.asarray(ypr, np.float32))
        R = reference.rot_from_ypr(yt).numpy()
        return (np.asarray(t, np.float32), np.asarray(ypr, np.float32), R,
                0.1)

    def still_batch(imgs, xyz, rgb, ts, yprs, *a, **k):
        return [still_one(None, None, None, t, y) for t, y in zip(ts, yprs)]

    monkeypatch.setattr(tracking, "track_step_fetched", still_one)
    monkeypatch.setattr(tracking, "track_steps_batched", still_batch)


def _altered_track(monkeypatch):
    from piccolo_tpu_torch import tracking

    one, batch = tracking.track_step_fetched, tracking.track_steps_batched

    def alt(res):
        t, ypr, R, loss = res
        return _shift(t), ypr, R, loss

    monkeypatch.setattr(tracking, "track_step_fetched",
                        lambda *a, **k: alt(one(*a, **k)))
    monkeypatch.setattr(tracking, "track_steps_batched",
                        lambda *a, **k: [alt(r) for r in batch(*a, **k)])


def _half_batch(monkeypatch):
    """Half of the frames left out: a batch computes its first half and
    hands the rest row 0's answer; frames answered alone take turns, every
    second one handed the answer last computed (another stream's, as the
    streams interleave on the compute lock)."""
    from piccolo_tpu_torch import tracking

    one, batch = tracking.track_step_fetched, tracking.track_steps_batched
    state = {"n": 0, "last": None}

    def half(imgs, xyz, rgb, ts, yprs, *a, **k):
        k_half = max(1, len(ts) // 2)
        done = batch(imgs[:k_half], xyz, rgb, ts[:k_half], yprs[:k_half],
                     *a, **k)
        return [done[i] if i < k_half else done[0] for i in range(len(ts))]

    def lone(*a, **k):
        state["n"] += 1
        if state["n"] % 2 == 0 and state["last"] is not None:
            return state["last"]
        state["last"] = one(*a, **k)
        return state["last"]

    monkeypatch.setattr(tracking, "track_steps_batched", half)
    monkeypatch.setattr(tracking, "track_step_fetched", lone)


@pytest.mark.parametrize("workload,plant", [
    ("omniscenes.query", _unchanged_query),
    ("omniscenes.query", _altered_query),
    ("omniscenes.track", _unchanged_track),
    ("omniscenes.track", _altered_track),
    ("omniscenes.track", _half_batch),
], ids=["query-unchanged", "query-altered", "track-unchanged",
        "track-altered", "track-half-batch"])
def test_a_planted_fault_is_not_correct(root, monkeypatch, workload, plant):
    plant(monkeypatch)
    assert not tiny.run(root, workload, SEED)["correct"]


def test_calibration_faults_read_above_the_limits(root):
    """The readings calibrate.py takes on the card, at this size."""
    doc = spec.load_spec(root)
    cell = spec.cell(doc, "omniscenes.track")
    cfg = spec.load_config(doc, cell["config"], root)
    mix = spec.load_traffic(cell["traffic"], root / "benchmark")
    xyz, rgb, wl = run.build(cfg, mix, SEED, "cpu")
    records = []
    for s in wl.streams:
        for f in s[1:3]:
            t, R = wl.gt[f]
            records.append(dict(image=f, tracked=True, client=s[0], t=t, R=R,
                                prev={"t": wl.gt[f - 1][0].tolist(),
                                      "ypr": list(reference.ypr_of(
                                          wl.gt[f - 1][1]))}))
    got = calibrate.faults(cfg, xyz, rgb, wl, records, SEED, "cpu")
    assert got["track_regret.half_batch"] > tiny.LIMITS["track_regret"]
    assert got["track_regret.unchanged"] > 0
