"""Tracking (``piccolo_tpu_torch.tracking``) and the OmniScenes CLI's tracking
loop against the JAX package's, on the CPU.

  * ``track_step``, ``track_step_prepped_fetched`` (no colour, ``cdf``,
    ``sharpen``, both) and ``Tracker`` from the same numpy inputs as JAX's:
    within 1e-3 m and 0.05 deg at the tracking defaults (lr 0.03, 30
    iterations).  The device colour prep differs from JAX's by f32
    quantile noise and the jitted ``/255`` (a reciprocal multiply in XLA),
    which the short descent keeps well inside that.
  * ``track_steps_batched`` (K streams as one K-start descent on stacked
    tables) against JAX's vmapped batch, and against per-stream
    ``track_step``: bit for bit at K = 1, within 1e-4 at K = 2 (the batch's
    backward reduction adds in another order).
  * ``Tracker``'s recovery on a teleport, its ``lost`` flag and NaN
    hardening, and ``DivergenceGate``, as ``tests/test_tracking.py`` holds
    the JAX package's; ``ypr_from_rot`` round-trips.
  * The OmniScenes CLI with ``tracking = True`` (seed, then tracked frames)
    against the JAX CLI on a ray-cast tree: the same ``tracking :`` mode per
    frame, poses within 1e-3 m.  The tracked descent amplifies the seed's
    ulp-level difference at lr 0.03 (as the reference descent does at lr
    0.1, ROADMAP Queue 3), so the comparison runs the tracked frames at lr
    0.01 and 20 iterations, as ``test_torch_cli.py`` runs the full query.
    At main size the tracked frames take the device colour prep, held
    against the port's own host prep of the same frames.
"""

import csv
import os
import re

import numpy as np
import pytest
import torch

from piccolo_tpu_torch import tracking as T
from piccolo_tpu_torch.harness.localize import _order_bounds
from piccolo_tpu_torch.main import main as tmain
from piccolo_tpu_torch.testing import (
    make_scene,
    raycast_pano,
    scene_cloud,
    write_synth_omniscenes,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def room():
    rng = np.random.default_rng(5)
    scene = make_scene(rng, size=(6.0, 4.0, 3.0), n_occluders=1,
                       texture="checker")
    xyz, rgb = scene_cloud(scene, rng, 9000)
    lo, hi = _order_bounds(xyz, 0.05)
    return scene, xyz.astype(np.float32), rgb.astype(np.float32), lo, hi


def _trajectory(n, start=(-1.0, -0.8, 0.1), yaw0=0.6):
    """A smooth handheld-like path: ~3 cm + ~1.2 deg per frame."""
    ts, yprs = [], []
    for i in range(n):
        ts.append(np.array([start[0] + 0.03 * i,
                            start[1] + 0.02 * np.sin(i / 3.0),
                            start[2] + 0.01 * np.cos(i / 4.0)], np.float32))
        yprs.append(np.array([yaw0 + 0.02 * i, 0.0, 0.0], np.float32))
    return ts, yprs


GT_T = np.array([0.3, -0.5, 0.2], np.float32)
GT_YPR = np.array([1.0, 0.0, 0.0], np.float32)
PREV_T = GT_T + np.array([0.04, -0.03, 0.02], np.float32)
PREV_YPR = GT_YPR + np.array([0.03, 0.0, 0.0], np.float32)


def _close(a, b):
    """Within 1e-3 m and 0.05 deg."""
    assert np.abs(np.asarray(a[0]) - np.asarray(b[0])).max() < 1e-3, (a, b)
    assert np.degrees(np.abs(np.asarray(a[1]) - np.asarray(b[1])).max()) < 0.05


def _jax_args(xyz, rgb, lo, hi):
    import jax.numpy as jnp

    return (jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(lo),
            jnp.asarray(hi))


def test_track_step_matches_jax(room):
    import jax.numpy as jnp

    from piccolo_tpu import tracking as J

    scene, xyz, rgb, lo, hi = room
    img = raycast_pano(scene, GT_T, GT_YPR, (128, 256))
    jx, jr, jlo, jhi = _jax_args(xyz, rgb, lo, hi)
    want = J.track_step_fetched(jnp.asarray(img), jx, jr, PREV_T, PREV_YPR,
                                jlo, jhi)
    res = T.track_step(img, xyz, rgb, PREV_T, PREV_YPR, lo, hi, device="cpu")
    assert res.t.shape == (1, 3) and res.loss.shape == (1,)
    got = T.track_step_fetched(img, xyz, rgb, PREV_T, PREV_YPR, lo, hi,
                               device="cpu")
    np.testing.assert_array_equal(got[0], res.t[0].numpy())
    _close(got, want)
    np.testing.assert_allclose(got[2], want[2], atol=1e-3)
    assert abs(got[3] - want[3]) < 1e-5
    assert np.linalg.norm(got[0] - GT_T) < 0.02


@pytest.mark.parametrize("colour", ["none", "cdf", "sharpen", "cdf+sharpen"])
def test_track_step_prepped_matches_jax(room, colour):
    import jax.numpy as jnp

    from piccolo_tpu import color as jcolor
    from piccolo_tpu import tracking as J
    from piccolo_tpu_torch.color import cloud_color_cdf, cloud_sharpen_state

    scene, xyz, rgb, lo, hi = room
    img_u8 = (raycast_pano(scene, GT_T, GT_YPR, (128, 256)) * 255).astype(
        np.uint8)
    kw = {}
    if "cdf" in colour:
        kw["cdf"] = cloud_color_cdf(rgb)
    if "sharpen" in colour:
        kw["sharpen"] = cloud_sharpen_state(rgb, pad_to=rgb.shape[0])
    jkw = {}
    if "cdf" in kw:
        jkw["cdf"] = tuple(jnp.asarray(a) for a in kw["cdf"])
    if "sharpen" in kw:
        jkw["sharpen"] = jcolor.SharpenState(
            *(jnp.asarray(a) for a in kw["sharpen"]))
    jx, jr, jlo, jhi = _jax_args(xyz, rgb, lo, hi)
    want = J.track_step_prepped_fetched(jnp.asarray(img_u8), jx, jr, PREV_T,
                                        PREV_YPR, jlo, jhi, **jkw)
    got = T.track_step_prepped_fetched(img_u8, xyz, rgb, PREV_T, PREV_YPR,
                                       lo, hi, device="cpu", **kw)
    _close(got, want)
    assert abs(got[3] - want[3]) < 1e-4
    if colour == "none":  # only the uint8 normalize differs: f32 noise
        ref = T.track_step_fetched(img_u8.astype(np.float32) / 255.0, xyz,
                                   rgb, PREV_T, PREV_YPR, lo, hi,
                                   device="cpu")
        for a, b in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(a, b)


def test_tracker_matches_jax(room):
    import jax.numpy as jnp

    from piccolo_tpu import tracking as J

    scene, xyz, rgb, lo, hi = room
    ts, yprs = _trajectory(5)
    jx, jr, jlo, jhi = _jax_args(xyz, rgb, lo, hi)
    jt = J.Tracker(jx, jr, jlo, jhi, ts[0], yprs[0], window=3)
    tt = T.Tracker(xyz, rgb, lo, hi, ts[0], yprs[0], window=3, device="cpu")
    for t_gt, ypr_gt in zip(ts[1:], yprs[1:]):
        img = raycast_pano(scene, t_gt, ypr_gt, (128, 256))
        a, b = tt.update(img), jt.update(jnp.asarray(img))
        assert (a.recovered, a.lost) == (b.recovered, b.lost) == (False, False)
        _close((a.t, a.ypr), (b.t, b.ypr))
        assert np.linalg.norm(a.t - t_gt) < 0.03


def test_track_steps_batched_equals_track_step(room):
    """One batch equals each stream's own track_step: bit for bit at K = 1
    (the same descent), and at K = 2 within 1e-4 m, 1e-4 rad and a
    relative 1e-4 of the loss.  The forward is bit-equal, but the batch's
    backward sums a stream's gradient terms over the cloud in another
    order (the reduction's shape has K rows), and the 30 Adam steps carry
    that ulp difference to 1e-5 m here."""
    scene, xyz, rgb, lo, hi = room
    gts = [(GT_T, GT_YPR),
           (np.float32([-0.8, 0.4, -0.1]), np.float32([2.2, 0, 0]))]
    imgs = np.stack([raycast_pano(scene, t, y, (128, 256)) for t, y in gts])
    off_t, off_y = np.float32([0.04, -0.03, 0.02]), np.float32([0.03, 0, 0])
    prev_ts = np.stack([t + off_t for t, _ in gts])
    prev_yprs = np.stack([y + off_y for _, y in gts])
    batched = T.track_steps_batched(imgs, xyz, rgb, prev_ts, prev_yprs, lo,
                                    hi, device="cpu")
    assert len(batched) == 2
    for k, (gt_t, _) in enumerate(gts):
        single = T.track_step_fetched(imgs[k], xyz, rgb, prev_ts[k],
                                      prev_yprs[k], lo, hi, device="cpu")
        one = T.track_steps_batched(imgs[k:k + 1], xyz, rgb, prev_ts[k:k + 1],
                                    prev_yprs[k:k + 1], lo, hi,
                                    device="cpu")[0]
        for a, b in zip(one, single):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(batched[k][:3], single[:3]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        assert abs(batched[k][3] - single[3]) <= 1e-4 * abs(single[3])
        assert np.linalg.norm(batched[k][0] - gt_t) < 0.02


def test_track_steps_batched_matches_jax(room):
    """The one-program batch of both packages (JAX's vmapped _track_batch)
    on the same frames: each stream within 1e-3 m and 0.05 deg, and its
    loss within 1e-5, as test_track_step_matches_jax holds one stream."""
    import jax.numpy as jnp

    from piccolo_tpu import tracking as J

    scene, xyz, rgb, lo, hi = room
    ts, yprs = _trajectory(4)
    imgs = np.stack([raycast_pano(scene, t, y, (128, 256))
                     for t, y in zip(ts[1:], yprs[1:])])
    prev_ts, prev_yprs = np.stack(ts[:3]), np.stack(yprs[:3])
    jx, jr, jlo, jhi = _jax_args(xyz, rgb, lo, hi)
    want = J.track_steps_batched(jnp.asarray(imgs), jx, jr, prev_ts,
                                 prev_yprs, jlo, jhi)
    got = T.track_steps_batched(imgs, xyz, rgb, prev_ts, prev_yprs, lo, hi,
                                device="cpu")
    assert len(got) == len(want) == 3
    for g, w, t_gt in zip(got, want, ts[1:]):
        _close(g, w)
        assert abs(g[3] - w[3]) < 1e-5
        assert np.linalg.norm(g[0] - t_gt) < 0.03


def test_tracker_recovery_on_teleport(room):
    scene, xyz, rgb, lo, hi = room
    ts, yprs = _trajectory(6)
    far_t = np.array([1.8, 1.2, -0.4], np.float32)
    far_ypr = np.array([3.5, 0.0, 0.0], np.float32)
    calls = []

    def recover(img):
        calls.append(1)
        return far_t, far_ypr  # stand-in for a full localize_query

    tracker = T.Tracker(xyz, rgb, lo, hi, ts[0], yprs[0], window=4,
                        recover=recover, device="cpu")
    for t_gt, ypr_gt in zip(ts[1:], yprs[1:]):
        out = tracker.update(raycast_pano(scene, t_gt, ypr_gt, (128, 256)))
        assert not out.recovered
    out = tracker.update(raycast_pano(scene, far_t, far_ypr, (128, 256)))
    assert out.recovered and calls == [1]
    assert float(np.linalg.norm(out.t - far_t)) < 0.03
    nxt = far_t + np.float32([0.03, 0, 0])
    out = tracker.update(raycast_pano(scene, nxt, far_ypr, (128, 256)))
    assert not out.recovered and not out.lost
    assert float(np.linalg.norm(out.t - nxt)) < 0.03


def test_tracker_flags_lost_without_recover(room):
    scene, xyz, rgb, lo, hi = room
    ts, yprs = _trajectory(6)
    tracker = T.Tracker(xyz, rgb, lo, hi, ts[0], yprs[0], window=4,
                        device="cpu")
    for t_gt, ypr_gt in zip(ts[1:], yprs[1:]):
        tracker.update(raycast_pano(scene, t_gt, ypr_gt, (128, 256)))
    out = tracker.update(raycast_pano(scene, np.float32([1.8, 1.2, -0.4]),
                                      np.float32([3.5, 0, 0]), (128, 256)))
    assert out.lost and not out.recovered


def test_tracker_nan_loss_keeps_previous_pose(room, monkeypatch):
    _, xyz, rgb, lo, hi = room
    t0 = np.float32([0.1, 0.2, 0.0])
    tracker = T.Tracker(xyz, rgb, lo, hi, t0, np.zeros(3, np.float32),
                        window=2, device="cpu")
    bad = (np.float32([np.nan] * 3), np.float32([np.nan] * 3),
           np.full((3, 3), np.nan, np.float32), float("nan"))
    monkeypatch.setattr(tracker, "_descend", lambda img: bad)
    out = tracker.update(np.zeros((8, 16, 3), np.float32))
    assert out.lost and not out.recovered
    np.testing.assert_array_equal(out.t, t0)
    np.testing.assert_allclose(out.rot, np.eye(3), atol=0)
    np.testing.assert_array_equal(tracker.pose[0], t0)


def test_divergence_gate_nan_hardening():
    gate = T.DivergenceGate(window=3, ratio=3.0)
    assert gate.diverged(float("nan")) and gate.diverged(float("inf"))
    for v in (0.1, 0.11, 0.09):
        assert not gate.diverged(v)
        gate.accept(v)
    gate.accept(float("nan"))  # never accepted into the window
    assert not gate.diverged(0.12)
    assert gate.diverged(0.5)  # 5x the median trips
    gate.reset()
    assert not gate.diverged(99.0)


def test_ypr_from_rot_roundtrip():
    from piccolo_tpu_torch.ops.rotation import rot_from_ypr

    rng = np.random.default_rng(7)
    for _ in range(20):
        ypr = np.float32([rng.uniform(-np.pi, np.pi), rng.uniform(-1.4, 1.4),
                          rng.uniform(-np.pi, np.pi)])
        R = rot_from_ypr(torch.tensor(ypr)).numpy()
        R2 = rot_from_ypr(torch.tensor(T.ypr_from_rot(R))).numpy()
        np.testing.assert_allclose(R2, R, atol=1e-5)


def test_track_kwargs_and_refusals(tmp_path):
    from piccolo_tpu_torch.config import make_config

    assert T.track_kwargs(make_config(track_lr=0.01, seam_wrap=True)) == dict(
        num_iter=30, lr=0.01, patience=3, factor=0.5, table_dtype="auto",
        wrap=True)
    # exec_cache_dir (refused before the executable-cache slice) loads the
    # process's libraries from the cache and changes no result
    from piccolo_tpu_torch.kernels import _build
    from piccolo_tpu_torch.utils import exec_cache

    z = np.zeros((4, 3), np.float32)
    args = (np.zeros((8, 16, 3), np.float32), z, z, z[0], z[0], z[0],
            z[0] + 1)
    store = _build.library_store()
    try:
        got = T.track_step(*args, exec_cache_dir=str(tmp_path), device="cpu")
        assert _build.library_store().path == tmp_path.resolve()
    finally:
        _build.use_store(store)
        exec_cache.clear_memo()
    want = T.track_step(*args, device="cpu")
    for f in ("t", "ypr", "rot", "loss", "lr"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the OmniScenes CLI with tracking = True


@pytest.fixture(scope="module")
def omni_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("omni_track"))
    write_synth_omniscenes(root, rooms=1, queries=3, points=12000,
                           height=1024, seed=7, oracle="raycast")
    return root


def _write_cfg(path, root):
    """configs/omniscenes.ini at test_torch_omniscenes.py's small scale:
    256x128 init and main images, lr 0.01 and 20 iterations."""
    with open(path, "w") as f:
        f.write(f"""
[Default]
dataset = OmniScenes
data_root = {root}
sample_rate = 1
match_color = True
num_bins = 256
out_of_room_quantile = 0.05
num_trans = 12
xy_only = True
yaw_only = True
z_prior = 1.5
num_yaw = 4
criterion = loss_histogram
num_intermediate = 8
num_input = 4
init_downsample_h = 16
init_downsample_w = 16
main_downsample_h = 8
main_downsample_w = 8
num_split_h = 4
num_split_w = 4
lr = 0.01
num_iter = 20
patience = 5
factor = 0.8
visualize = False
tracking = True
track_lr = 0.01
track_num_iter = 20
""")
    return path


def _run(main, cfg, log, override, capsys, extra=()):
    main(["--config", cfg, "--log", log, "--no-tensorboard",
          "--override", override, *extra])
    out = capsys.readouterr().out
    with open(os.path.join(log, "omniscenes_results.csv"), newline="") as f:
        rows = list(csv.reader(f))[1:]
    poses = np.array([[float(v) for v in r[4].split()] for r in rows])
    return (re.findall(r"^tracking : (\w+)$", out, re.M),
            re.findall(r"^route : (.*)$", out, re.M), poses)


@pytest.mark.parametrize("override", [
    "data_root={root}", "data_root={root},sharpen_color=True",
], ids=["match_color", "match_and_sharpen"])
def test_omniscenes_cli_tracking_matches_jax(omni_root, override, tmp_path,
                                             capsys):
    from piccolo_tpu.main import main as jmain

    cfg = _write_cfg(str(tmp_path / "cfg.ini"), omni_root)
    ov = override.format(root=omni_root)
    modes, routes, got = _run(tmain, cfg, str(tmp_path / "port"), ov, capsys,
                              ("--device", "cpu"))
    jmodes, _, want = _run(jmain, cfg, str(tmp_path / "jax"), ov, capsys)
    assert modes == jmodes == ["seed", "tracked", "tracked"]
    # main_downsample 8: the tracked frames take the host colour prep
    assert routes[1:] == ["tracked: one warm-started descent"] * 2
    assert np.abs(got - want).max() < 1e-3


def test_omniscenes_cli_tracking_device_prep(omni_root, tmp_path, capsys):
    """At main size (main_downsample 1) the tracked frames take the device
    colour prep (match_color and sharpen_color); the same frames through
    the host prep (track_fast_prep = False) give the same modes and poses
    within 5e-3 m.  The two preps differ by f32 quantile noise, which moves
    a few pixels by one level; Adam's sign-normalised first steps carry
    that into mm-scale pose differences at main size, as between the
    frameworks (ROADMAP Queue 3)."""
    cfg = _write_cfg(str(tmp_path / "cfg.ini"), omni_root)
    ov = (f"data_root={omni_root},main_downsample_h=1,main_downsample_w=1,"
          "sharpen_color=True,descent_table=float32")
    modes, routes, fast = _run(tmain, cfg, str(tmp_path / "fast"), ov, capsys,
                               ("--device", "cpu"))
    hmodes, hroutes, host = _run(tmain, cfg, str(tmp_path / "host"),
                                 ov + ",track_fast_prep=False", capsys,
                                 ("--device", "cpu"))
    assert modes == hmodes == ["seed", "tracked", "tracked"]
    assert routes[1:] == [
        "tracked: one warm-started descent, device colour prep"] * 2
    assert hroutes[1:] == ["tracked: one warm-started descent"] * 2
    np.testing.assert_array_equal(fast[0], host[0])  # the seed: one path
    assert np.abs(fast - host).max() < 5e-3


def test_omniscenes_cli_tracking_profiled(omni_root, tmp_path, capsys):
    """profile_dir over the OmniScenes loop writes one trace a frame and
    changes no row but for time.  The run covers what the trace wraps: the
    seed's fused query, a tracked frame with the device colour prep, and a
    recovery (track_window 1 and track_recover_ratio 0: the third frame's
    loss exceeds 0 x the median of one accepted loss, so it diverges)."""
    cfg = _write_cfg(str(tmp_path / "cfg.ini"), omni_root)
    ov = (f"data_root={omni_root},main_downsample_h=1,main_downsample_w=1,"
          "sharpen_color=True,descent_table=float32,track_window=1,"
          "track_recover_ratio=0")
    traces = tmp_path / "traces"
    got = []
    for name, extra in (("plain", ""), ("profiled", f",profile_dir={traces}")):
        modes, routes, _ = _run(tmain, cfg, str(tmp_path / name), ov + extra,
                                capsys, ("--device", "cpu"))
        with open(tmp_path / name / "omniscenes_results.csv",
                  newline="") as f:
            rows = list(csv.reader(f))
        t_col = rows[0].index("time (s)")
        got.append((modes, routes,
                    [[c for i, c in enumerate(r) if i != t_col]
                     for r in rows]))
    assert got[0] == got[1]
    modes, routes, rows = got[1]
    assert modes == ["seed", "tracked", "recovered"]
    assert routes[1] == "tracked: one warm-started descent, device colour prep"
    assert len(rows) == 4
    names = sorted(os.listdir(traces))
    assert len(names) == 3
    assert all(n.endswith(".pt.trace.json") for n in names)
