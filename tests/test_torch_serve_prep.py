"""The service's prep on the room's device (``serve.LocalizeService`` with
``harness.localize.prepare_images_card``), on the CPU, where the histogram
kernels run their plain versions.

  * The device prep equals the harness's numpy prep of the same uint8
    image and room: bit for bit without a colour mode; under
    ``match_color`` (OmniScenes) within one uint8 level at a small share
    of pixels (the image-side quantiles are f32 here and f64 on the host,
    ~1e-6 relative, and the uint8 requantisation can carry that across a
    level); under ``sharpen_color`` within one luminance level, image and
    rebound cloud colours (the LUT's exact integer floor), as ``color.py``
    documents.
  * A served answer under each colour mode equals ``_run_fused`` over
    ``svc._prepare``'s inputs bit for bit, with one ``service.prep`` span
    and one ``service.prep_card`` count under the request.
  * The gate: both shipped configs take the device prep; a config that
    saves starting points, downsamples the main or the init image, runs
    ``sharpen_color`` on 128 bins or sets ``track_fast_prep = False``
    keeps the numpy prep, and the counters say which ran.
  * Two concurrent tracked requests under ``match_color`` still drain as
    one batch, the leader finishing both preps under the batch.
  * The compute lock passes to its waiters in arrival order.

OmniScenes resizes every panorama to 2048x1024 in its uint8 head
(``resize_ablate_omniscenes``), an identity on the shipped 2048x1024
frames.  The OmniScenes cases here replace that head in the service by the
identity, so they run at a small size as the shipped case runs at full
size.

The device prep is also held directly against the JAX package's prep of
the same panorama and room, at 2048x1024.

Marked ``cuda`` (skips without a card; on the card run with ``--noconftest``:
only the JAX comparison imports JAX, inside its test): the device prep of a 2048x1024 frame on the card
equals the same function on the CPU within the same deltas, and launches
no host synchronisation between the upload and the solve; and every uint8
level converts there as numpy converts it, through ``tracking.upload_frame``
and through the device prep's main image (also run on the CPU).
"""

import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from piccolo_tpu_torch import serve as serve_mod
from piccolo_tpu_torch.config import make_config
from piccolo_tpu_torch.harness.localize import (
    _card_prep_ok,
    _pad_cloud,
    _room_colour_state,
    finish_omniscenes_images,
    prepare_images_card,
    prepare_stanford_images,
)
from piccolo_tpu_torch.serve import LocalizeService
from piccolo_tpu_torch.testing import make_room, render_at
from piccolo_tpu_torch.tracking import track_kwargs, upload_frame
from piccolo_tpu_torch.utils import profiling

torch.set_num_threads(2)

_CFG = dict(
    xy_only=True, num_trans=16, yaw_only=True, num_yaw=4, z_prior=None,
    num_split_h=4, num_split_w=4, num_intermediate=8, num_input=4,
    num_iter=20, lr=0.01, patience=5, factor=0.8,
)
OMNI = dict(dataset="OmniScenes", match_color=True, init_downsample_h=2,
            init_downsample_w=2)
STANFORD = dict(dataset="Stanford2D-3D-S", sharpen_color=True)
MODES = {
    "none": dict(dataset="Stanford2D-3D-S"),
    "omniscenes-match": OMNI,
    "omniscenes-match-sharpen": dict(OMNI, sharpen_color=True),
    "stanford-sharpen": STANFORD,
}
LEVEL = 1.001 / 255.0


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    xyz, rgb = make_room(rng, n_per_wall=1500, texture="checker")
    gt_t = np.array([0.4, -0.2, 0.15], np.float32)
    img = render_at(xyz, rgb, gt_t, np.float32([0.9, 0.0, 0.0]), (128, 256),
                    device="cpu").numpy()
    img = (img * 255).astype(np.uint8)
    img[:4, :8] = 0  # black pixels stay black under every colour mode
    return xyz, rgb, img, gt_t


@pytest.fixture
def head_identity(monkeypatch):
    """The service's OmniScenes uint8 head as the identity it is on a
    2048x1024 panorama."""
    monkeypatch.setattr(serve_mod, "resize_ablate_omniscenes",
                        lambda cfg, raw: raw)


def _svc(scene, **kw):
    xyz, rgb, _, _ = scene
    svc = LocalizeService(device="cpu", **{**_CFG, **kw})
    svc.load_room(xyz, rgb, name="box")
    return svc


def _host_prep(svc, img, cache):
    if "mni" in svc.cfg.dataset:
        return finish_omniscenes_images(svc.cfg, img, cache)[1:]
    return prepare_stanford_images(svc.cfg, img, cache)


def _within_a_level(got, want, share):
    """``got`` within one uint8 level of ``want`` everywhere, and a whole
    level off at most ``share`` of its entries (the rest differ by f32
    rounding at most: the card's ``/ 255`` inside the colour functions is a
    multiply by the reciprocal)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    off = float((diff > 0.5 / 255.0).mean())
    assert diff.max() <= LEVEL and off <= share, (float(diff.max()), off)


def _traced(fn):
    """Run ``fn`` under a CPU profiler session that records every thread
    where the installed PyTorch can; returns its result and the span
    store's records of the session."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU], **kw):
        out = fn()
    return out, profiling.span_records(t0, time.time_ns())


@pytest.mark.parametrize("mode", list(MODES))
def test_card_prep_equals_host_prep(scene, mode, head_identity):
    _, _, img, _ = scene
    svc = _svc(scene, **MODES[mode])
    assert svc._card_prep
    cache = svc._rooms["box"][0]
    prep = svc._prep_head(img, cache)
    assert prep.img is img and prep.done is None
    got = svc._finish(prep, cache)
    assert svc._finish(prep, cache) is got  # finished once
    want = _host_prep(svc, img, cache)
    gi, gm, grgb, timed = got
    wi, wm, wrgb, _ = want
    assert isinstance(gi, torch.Tensor) and gi.dtype == torch.float32
    assert gi.shape == tuple(wi.shape) and gm.shape == tuple(wm.shape)
    assert timed >= 0
    if mode == "none":
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gm.numpy(), wm)
        assert grgb is cache["rgb"] is wrgb
        return
    if mode.startswith("omniscenes"):
        assert gi is gm  # one image serves both stages
        _within_a_level(gi.numpy(), wi, 0.01)
        _within_a_level(gm.numpy(), wm, 0.01)
    else:  # Stanford sharpens the init image only
        _within_a_level(gi.numpy(), wi, 0.01)
        np.testing.assert_array_equal(gm.numpy(), wm)
    assert np.all(gi.numpy()[:4, :8] == 0.0)
    if "sharpen" in mode:
        assert grgb is not cache["rgb"] and grgb.shape == wrgb.shape
        _within_a_level(grgb.numpy(), wrgb.cpu().numpy(), 0.01)
    else:
        assert grgb is cache["rgb"] is wrgb


@pytest.mark.parametrize("mode", [m for m in MODES if m != "none"])
def test_card_prep_equals_jax_prep(scene, mode):
    """The device prep against the JAX package's own prep
    (``prepare_omniscenes_images`` / ``prepare_stanford_images``) of the
    same uint8 panorama and room, at 2048x1024, where OmniScenes' resize
    to 2048x1024 is the identity: within the limits it keeps against the
    port's host prep."""
    from piccolo_tpu.config import make_config as jax_config
    from piccolo_tpu.harness import localize as jhl

    xyz, rgb, img, _ = scene
    big = np.repeat(np.repeat(img, 8, axis=0), 8, axis=1)
    kw = {**_CFG, **MODES[mode]}
    cfg, omni = make_config(**kw), mode.startswith("omniscenes")
    assert big.shape == (1024, 2048, 3) and _card_prep_ok(cfg, omni)
    xyz_d, rgb_d, mask_d = _pad_cloud(xyz, rgb, "cpu")
    room = dict(xyz_np=xyz, rgb_np=rgb, xyz=xyz_d, rgb=rgb_d, mask=mask_d,
                device=torch.device("cpu"))
    _room_colour_state(cfg, room)
    got = prepare_images_card(cfg, big, room, omni)
    jroom = dict(rgb=rgb_d.numpy(), rgb_np=rgb, mask=mask_d.numpy())
    want = (jhl.prepare_omniscenes_images(jax_config(**kw), big, jroom)[1:]
            if omni else jhl.prepare_stanford_images(jax_config(**kw), big,
                                                     jroom))
    for k in range(2):  # init and main image
        assert got[k].shape == np.shape(want[k])
        _within_a_level(got[k].numpy(), np.asarray(want[k]), 0.01)
        assert np.all(got[k].numpy()[:32, :64] == 0.0)
    if not omni:  # Stanford's main image is not sharpened
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if "sharpen" in mode:
        _within_a_level(got[2].numpy(), np.asarray(want[2]), 0.01)
    else:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("mode", ["omniscenes-match", "stanford-sharpen"])
def test_served_answer_equals_run_fused_on_card_prep(scene, mode,
                                                     head_identity):
    from piccolo_tpu_torch.harness.localize import _run_fused

    _, _, img, gt_t = scene
    # the full budget, as the serving tests run it, so the answer is sound
    svc = _svc(scene, num_iter=60, lr=0.1, **MODES[mode])
    out, recs = _traced(lambda: svc.localize(img))
    cache = svc._rooms["box"][0]
    img_init, img_main, rgb_used, _ = svc._prepare(img, cache)
    res, _ = _run_fused(img_init, img_main, cache, rgb_used, svc.cfg,
                        svc.init_dict, cache["grids"], sync_plans=True)
    np.testing.assert_array_equal(out["t"], res.t.numpy())
    np.testing.assert_array_equal(out["rot"], res.rot.numpy())
    np.testing.assert_array_equal(out["cand_loss"], res.cand_loss.numpy())
    assert out["loss"] == float(res.loss) and out["winner"] == int(res.winner)
    assert np.linalg.norm(out["t"] - gt_t) < 0.2
    (root,) = [r for r in recs if r.name == "service.request"]
    mine = [r for r in recs if r.requests == root.requests]
    names = Counter(r.name for r in mine if r.n is None)
    assert names["service.prep"] == 1
    (prep,) = [r for r in mine if r.name == "service.prep"]
    (wait,) = [r for r in mine if r.name == "service.lock_wait"]
    (solve,) = [r for r in mine if r.name == "service.solve"]
    # the prep runs under the compute lock, before the solve
    assert prep.parent == root.id
    assert wait.end_ns <= prep.start_ns <= prep.end_ns <= solve.start_ns
    assert any(r.name == "service.prep.color" and r.parent == prep.id
               for r in mine)
    counts = {r.name: r.n for r in mine if r.n is not None
              and r.name.startswith("service.prep_")}
    assert counts == {"service.prep_card": 1}


@pytest.mark.parametrize("kw,card", [
    (OMNI, True),
    (STANFORD, True),
    (dict(STANFORD, save_starting_point=True), False),
    (dict(STANFORD, main_downsample_h=2, main_downsample_w=2), False),
    (dict(STANFORD, init_downsample_h=2, init_downsample_w=2), False),
    (dict(OMNI, init_downsample_h=4, init_downsample_w=4), False),
    (dict(STANFORD, num_bins=128), False),
    (dict(STANFORD, track_fast_prep=False), False),
], ids=["omniscenes.ini", "stanford.ini", "save_starting_point",
        "main_downsample", "init_downsample", "omniscenes_init_downsample",
        "num_bins_128", "track_fast_prep_off"])
def test_card_prep_gate(scene, kw, card):
    """The gate on the config, and what a served tracked frame's counters
    say ran: its prep, and its descent's steps."""
    assert _card_prep_ok(make_config(**{**_CFG, **kw}),
                         "mni" in kw["dataset"]) is card
    if "mni" in kw["dataset"]:
        return  # the served OmniScenes head resizes to 2048x1024
    _, _, img, gt_t = scene
    svc = _svc(scene, **kw)
    assert svc._card_prep is card
    cache = svc._rooms["box"][0]
    assert ("sharpen" in cache) is card
    # the host's prep is done before the lock, the card's waits for it
    assert (svc._prep_head(img, cache).done is None) is card
    prev = {"t": gt_t.tolist(), "ypr": [0.9, 0.0, 0.0]}
    out, recs = _traced(lambda: svc.localize(img, prev_pose=prev))
    assert out["tracked"]
    (root,) = [r for r in recs if r.name == "service.request"]
    counts = {r.name: r.n for r in recs if r.n is not None
              and r.requests == root.requests}
    # the frame's descent on the CPU: the autograd step, its steps counted
    steps = track_kwargs(svc.cfg)["num_iter"]
    assert counts == {"service.prep_card" if card else "service.prep_host": 1,
                      "descent.steps_plain": steps}
    assert sum(r.name == "service.prep" for r in recs) == 1


def test_track_batch_drains_card_preps(scene, head_identity):
    """Two tracked frames under ``match_color`` queued (their uint8 heads
    only) while the device is held drain as one batch: the leader finishes
    both card preps inside it, each on its own request's ids, and each
    answer equals ``track_steps_batched`` over the frames' ``svc._prepare``
    bit for bit."""
    from piccolo_tpu_torch.tracking import track_steps_batched

    xyz, rgb, img, gt_t = scene
    svc = _svc(scene, track_batch=True, track_max_batch=4, **OMNI)
    prev = {"t": gt_t.tolist(), "ypr": [0.9, 0.0, 0.0]}
    frames = [(render_at(xyz, rgb, gt_t + d, np.float32([0.92, 0, 0]),
                         (128, 256), device="cpu").numpy() * 255)
              .astype(np.uint8)
              for d in (np.float32([0.03, -0.02, 0.01]),
                        np.float32([-0.02, 0.03, 0.0]))]
    outs = [None] * 2

    def two_frames():
        lock = svc._compute_locks[0]
        lock.acquire()
        try:
            threads = [threading.Thread(
                target=lambda i=i: outs.__setitem__(
                    i, svc.localize(frames[i], prev_pose=prev)))
                for i in range(2)]
            for th in threads:
                th.start()
            for _ in range(600):
                if len(svc._track_queues[0]) == 2:
                    break
                threading.Event().wait(0.05)
            # queued with only their uint8 heads done
            assert all(e["prep"].done is None
                       for e in svc._track_queues[0])
        finally:
            lock.release()
        for th in threads:
            th.join(300)
        assert not any(th.is_alive() for th in threads)

    _, recs = _traced(two_frames)
    assert [o["batched"] for o in outs] == [2, 2]
    cache = svc._rooms["box"][0]
    mains = [svc._prepare(f, cache)[1] for f in frames]
    t0, y0 = svc._parse_prev_pose(prev)
    want = track_steps_batched(
        torch.stack(mains), cache["xyz"], cache["rgb"], np.stack([t0] * 2),
        np.stack([y0] * 2), cache["lo"], cache["hi"], cache["mask"],
        **svc._track_kw())
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o["t"], w[0])
        np.testing.assert_array_equal(o["ypr"], w[1])
        assert o["loss"] == w[3]
    roots = sorted(r.requests[0] for r in recs if r.name == "service.request")
    (batch,) = [r for r in recs if r.name == "track.batch"]
    preps = [r for r in recs if r.name == "service.prep"]
    assert sorted(r.requests[0] for r in preps) == roots
    assert all(r.parent == batch.id for r in preps)
    cards = [r for r in recs if r.name == "service.prep_card"]
    assert sorted(r.requests[0] for r in cards) == roots
    assert not [r for r in recs if r.name == "service.prep_host"]


def test_compute_lock_hands_over_in_arrival_order():
    """The compute lock passes to its waiters in arrival order: a thread
    that releases it and asks again at once queues behind them."""
    lock = serve_mod._FairLock()
    lock.acquire()
    order = []

    def take(i):
        lock.acquire()
        order.append(i)
        lock.release()

    threads = []
    for i in range(3):
        threads.append(threading.Thread(target=take, args=(i,)))
        threads[-1].start()
        for _ in range(600):
            if len(lock._waiters) == i + 1:
                break
            time.sleep(0.005)
        assert len(lock._waiters) == i + 1
    assert lock.locked()
    lock.release()
    lock.acquire()
    assert order == [0, 1, 2]
    lock.release()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads) and not lock.locked()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_card_prep_on_the_card_equals_the_cpu(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    xyz, rgb = make_room(rng, n_per_wall=4000, texture="checker")
    # a ray-cast-like uint8 frame at the shipped size, with black pixels
    img = render_at(xyz, rgb, np.float32([0.2, 0.1, 0.0]),
                    np.float32([0.4, 0.0, 0.0]), (1024, 2048),
                    device="cpu").numpy()
    img = (img * 255).astype(np.uint8)
    img[:16, :64] = 0
    cfg = make_config(**{**_CFG, **MODES[mode]})
    omni = mode.startswith("omniscenes")
    assert _card_prep_ok(cfg, omni)
    out = {}
    for d in (torch.device("cpu"), dev):
        xyz_d, rgb_d, mask_d = _pad_cloud(xyz, rgb, d)
        room = dict(xyz_np=xyz, rgb_np=rgb, xyz=xyz_d, rgb=rgb_d,
                    mask=mask_d, device=d)
        _room_colour_state(cfg, room)
        u8 = torch.as_tensor(img, device=d)  # the upload
        if d.type == "cuda":
            torch.cuda.synchronize(d)
            # the prep waits on nothing: no .item(), .cpu() or sync
            torch.cuda.set_sync_debug_mode("error")
            try:
                prep = prepare_images_card(cfg, u8, room, omni)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            prep = prepare_images_card(cfg, u8, room, omni)
        # no synchronize: the copies to the host follow the prep in stream
        # order
        out[d.type] = [x.cpu().numpy() if isinstance(x, torch.Tensor) else x
                       for x in prep]
    got, want = out["cuda"], out["cpu"]
    if mode == "none":  # the conversion alone: the same bits
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        return
    for k in range(2):  # init and main image
        _within_a_level(got[k], want[k], 0.01)
        assert np.all(got[k][:16, :64] == 0.0)
    if "sharpen" in mode:
        _within_a_level(got[2], want[2], 0.01)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_frame_upload_converts_as_numpy(device):
    """All 256 uint8 levels through ``tracking.upload_frame`` and through
    the main image of ``prepare_images_card`` without a colour mode: the
    bits of numpy's ``u8.astype(np.float32) / 255``.  On the card a
    division by the Python scalar 255 is a multiply by its reciprocal, an
    ulp off at 126 of the levels; on the CPU both give numpy's bits."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    dev = torch.device(device)
    u8 = np.repeat(np.arange(256, dtype=np.uint8).reshape(16, 16, 1), 3, 2)
    want = (u8.astype(np.float32) / 255).view(np.uint32)
    got = upload_frame(u8, dev).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)
    cfg = make_config(**{**_CFG, **MODES["none"]})
    _, main, _, _ = prepare_images_card(cfg, u8, dict(device=dev, rgb=None),
                                        False)
    np.testing.assert_array_equal(main.cpu().numpy().view(np.uint32), want)
