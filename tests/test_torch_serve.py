"""The port's serving surface (``piccolo_tpu_torch.serve``) and its room probe,
on the CPU.

  * A served answer equals the port's harness ``_run_fused`` on the same
    room and image bit for bit (one packed copy to the host).
  * The port's ``LocalizeService`` answers within 1e-3 m of the JAX
    package's at lr 0.01 and 20 iterations (the reference descent amplifies
    ulp-level differences past that, ROADMAP Queue 3).
  * The HTTP round trip: ``image_path``, ``image_b64`` as PNG and as JPEG
    (decoded by the port's own codecs), ``/room``, ``/healthz``, 400, 404
    and 503 beyond ``max_pending``; the payload trust model; the LRU and
    the plan budget of resident rooms.
  * ``room = "auto"`` picks the query's own room in the default, probe and
    batched modes (the last one probe over every room, the per-room probe
    under colour prep); the per-room probe ranks rooms as the JAX
    package's does.
  * Tracked requests (``prev_pose``), ``recover_above``, ``track_batch``
    draining concurrent tracked requests into one batch, and a request
    under ``sharpen_color`` descending alone on its rebound colours.
  * Under a profiler session: a served query's spans under one request id
    and its ``route``, a batch's spans over both of its requests' ids, and
    the stage-1 pair counters with a whole plan and with plans off.
  * ``query_devices = 2`` (two logical CPU replicas) answers requests in
    turn, each bit-equal to the single-device service; ``n_devices = 4``
    answers bit-equal to ``_run_fused`` over the same mesh and within 1e-3
    m of the single-device service.
  * The configs serving refuses, naming their slice where one is planned.
"""

import base64
import json
import threading
import time
import warnings
from collections import Counter
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from piccolo_tpu_torch.harness.imaging import jpeg_encode, png_encode
from piccolo_tpu_torch.serve import LocalizeService, serve_forever
from piccolo_tpu_torch.testing import make_room, render_at
from piccolo_tpu_torch.utils import profiling

torch.set_num_threads(2)

_CFG = dict(
    xy_only=True, num_trans=16, yaw_only=True, num_yaw=4, z_prior=None,
    num_split_h=4, num_split_w=4, num_intermediate=8, num_input=4,
    num_iter=20, lr=0.01, patience=5, factor=0.8,
)
# the JAX package's serving tests run the full budget at lr 0.1
_FULL = dict(_CFG, num_iter=60, lr=0.1)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    xyz, rgb = make_room(rng, n_per_wall=1500, texture="checker")
    gt_t = np.array([0.4, -0.2, 0.15], np.float32)
    gt_ypr = np.array([0.9, 0.0, 0.0], np.float32)
    img = render_at(xyz, rgb, gt_t, gt_ypr, (128, 256), device="cpu").numpy()
    return xyz, rgb, (img * 255).astype(np.uint8), gt_t


@pytest.fixture(scope="module")
def plain_room():
    return make_room(np.random.default_rng(17), n_per_wall=1500,
                     texture="plain")


@pytest.fixture
def library_store():
    """Restore the process's library store after a test that points it at
    an executable cache."""
    from piccolo_tpu_torch.kernels import _build
    from piccolo_tpu_torch.utils import exec_cache

    store = _build.library_store()
    yield
    _build.use_store(store)
    exec_cache.clear_memo()


def _svc(**kw):
    return LocalizeService(device="cpu", **{**_FULL, **kw})


def test_served_answer_equals_run_fused(scene):
    from piccolo_tpu_torch.harness.localize import _run_fused

    xyz, rgb, img, gt_t = scene
    svc = _svc()
    with pytest.raises(RuntimeError, match="no room"):
        svc.localize(img)
    svc.load_room(xyz, rgb, name="box")
    out = svc.localize(img)
    cache = svc._rooms["box"][0]
    img_init, img_main, rgb_used, _ = svc._prepare(img, cache)
    res, _ = _run_fused(img_init, img_main, cache, rgb_used, svc.cfg,
                        svc.init_dict, cache["grids"], sync_plans=True)
    np.testing.assert_array_equal(out["t"], res.t.numpy())
    np.testing.assert_array_equal(out["rot"], res.rot.numpy())
    np.testing.assert_array_equal(out["cand_loss"], res.cand_loss.numpy())
    assert out["loss"] == float(res.loss) and out["winner"] == int(res.winner)
    assert np.linalg.norm(out["t"] - gt_t) < 0.2
    assert out["room"] == "box" and out["device_index"] == 0
    assert 0 < out["time_s"] <= out["total_s"]
    # a float image is requantized to the uint8 the CLI decodes
    out2 = svc.localize(img.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(out2["t"], out["t"])
    with pytest.raises(ValueError, match="RGB"):
        svc.localize(np.zeros((4, 4), np.float32))


def test_service_matches_jax_service(scene):
    from piccolo_tpu.serve import LocalizeService as JaxService

    xyz, rgb, img, _ = scene
    port = LocalizeService(device="cpu", **_CFG)
    jax_svc = JaxService(**_CFG)
    for s in (port, jax_svc):
        s.load_room(xyz, rgb, name="box")
    a, b = port.localize(img), jax_svc.localize(img)
    assert a["winner"] == b["winner"]
    assert np.abs(a["t"] - np.asarray(b["t"])).max() < 1e-3
    assert np.abs(a["rot"] - np.asarray(b["rot"])).max() < 1e-3


def _post(base, path, payload, timeout=300):
    req = urllib.request.Request(f"{base}{path}",
                                 data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _http_error(base, path, data, method="POST"):
    req = urllib.request.Request(f"{base}{path}", data=data, method=method)
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=60)
    return ei.value


def test_http_roundtrip(scene, tmp_path):
    from piccolo_tpu_torch.harness.imaging import imwrite_rgb

    xyz, rgb, img, gt_t = scene
    svc = _svc(max_pending=1)
    svc.load_room(xyz, rgb, name="box")
    img_path = str(tmp_path / "query.png")
    imwrite_rgb(img_path, img)
    pcd = tmp_path / "room.txt"
    np.savetxt(pcd, np.concatenate([xyz, rgb * 255], 1), fmt="%.6f")
    want = svc.localize(img)

    ready = threading.Event()
    threading.Thread(target=serve_forever, args=(svc, "127.0.0.1", 0, ready),
                     daemon=True).start()
    assert ready.wait(10)
    server = ready.server
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {
                "ok": True, "room": "box", "rooms": ["box"], "busy": False,
                "devices": 1, "busy_devices": 0, "pending": 0,
                "max_pending": 1, "plan_bytes": {}}
        by_path = _post(base, "/localize", {"image_path": img_path})
        png = _post(base, "/localize", {
            "image_b64": base64.b64encode(png_encode(img)).decode()})
        jpg = _post(base, "/localize", {
            "image_b64": base64.b64encode(jpeg_encode(img)).decode()})
        for out in (by_path, png):  # lossless: the direct call's answer
            np.testing.assert_array_equal(np.float32(out["t"]), want["t"])
            assert out["loss"] == want["loss"] and out["total_s"] > 0
            assert out["route"] == want["route"]
        assert np.linalg.norm(np.array(jpg["t"]) - gt_t) < 0.2
        assert np.array(jpg["rot"]).shape == (3, 3)

        err = _http_error(base, "/localize", b"{}")
        assert err.code == 400 and "error" in json.loads(err.read())
        err = _http_error(base, "/localize", json.dumps(
            {"image_b64": base64.b64encode(b"GIF89a").decode()}).encode())
        assert err.code == 400
        assert _http_error(base, "/nowhere", b"{}").code == 404
        assert _http_error(base, "/nowhere", None, "GET").code == 404
        # beyond max_pending: 503 with Retry-After
        svc._pending = 1
        try:
            err = _http_error(base, "/localize", json.dumps(
                {"image_path": img_path}).encode())
        finally:
            svc._pending = 0
        assert err.code == 503 and err.headers["Retry-After"] == "1"

        assert _post(base, "/room", {"pcd_path": str(pcd)}) == {
            "ok": True, "room": str(pcd)}
        assert svc.rooms == [str(pcd)]  # max_rooms 1: the LRU evicted box
    finally:
        server.shutdown()


def test_payload_path_trust_model(tmp_path):
    from piccolo_tpu_torch.serve import _resolve_payload_path

    inside = tmp_path / "data" / "a.png"
    inside.parent.mkdir()
    inside.write_bytes(b"x")
    (tmp_path / "link").symlink_to(tmp_path)
    assert _resolve_payload_path("/etc/passwd", None, True) == "/etc/passwd"
    with pytest.raises(ValueError, match="non-loopback"):
        _resolve_payload_path(str(inside), None, False)
    root = str(tmp_path / "data")
    assert _resolve_payload_path(str(inside), root, True) == str(inside)
    for bad in ("/etc/passwd", str(tmp_path / "data" / ".." / "x"),
                str(tmp_path / "link" / "x")):
        with pytest.raises(ValueError, match="outside"):
            _resolve_payload_path(bad, root, True)


def test_lru_and_budget_cfg(scene, plain_room):
    from piccolo_tpu_torch.config import cfg_get

    xyz, rgb, img, gt_t = scene
    svc = _svc(max_rooms=2, slab_bytes_cap=1000)
    svc.load_room(xyz, rgb, name="a")
    svc.load_room(*plain_room, name="b")
    assert svc.rooms == ["a", "b"] and svc.room == "b"
    out = svc.localize(img, room="a")
    assert out["room"] == "a" and svc.room == "a"  # selection bumps the LRU
    assert np.linalg.norm(out["t"] - gt_t) < 0.2
    with pytest.raises(KeyError):
        svc.localize(img, room="nope")
    with pytest.raises(ValueError, match="reserved"):
        svc.load_room(xyz, rgb, name="auto")

    class FakePlan:
        nbytes = 600

    cache_a, cache_b = svc._rooms["a"][0], svc._rooms["b"][0]
    cache_a[("slab_plan", 64, 128, True, False, False, False)] = FakePlan()
    cfg_b = svc._budget_cfg(cache_b, 0)
    assert cfg_get(cfg_b, "slab_bytes_cap") == 400
    assert cfg_get(cfg_b, "hist_planes_bytes_cap") == 400
    assert cfg_get(cfg_b, "num_iter") == cfg_get(svc.cfg, "num_iter")
    assert svc._budget_cfg(cache_a, 0) is svc.cfg
    cache_a[("hist_plan", 64, 128)] = FakePlan()
    assert cfg_get(svc._budget_cfg(cache_b, 0), "slab_bytes_cap") == 0
    assert svc.plan_bytes() == {"cpu": 1200}  # /healthz's plan_bytes

    # a third room evicts the least recently used one and drops its plans
    svc.load_room(xyz, rgb, name="c")
    assert svc.rooms == ["a", "c"]
    svc.load_room(xyz, rgb, name="d")
    assert svc.rooms == ["c", "d"]
    assert not any(isinstance(k, tuple) for k in cache_a)

    solo = _svc()
    solo.load_room(xyz, rgb, name="solo")
    assert solo._budget_cfg(solo._rooms["solo"][0], 0) is solo.cfg


@pytest.mark.parametrize("mode", [False, True, "batched"])
def test_room_auto_picks_the_query_room(scene, plain_room, mode,
                                        monkeypatch):
    xyz, rgb, img, gt_t = scene
    svc = _svc(max_rooms=3, room_auto_probe=mode, room_auto_margin=1.0)
    svc.load_room(*plain_room, name="plain")
    svc.load_room(xyz, rgb, name="checker")
    full, probes, batched = [], [], []
    real_full, real_probe = svc._compute_room, svc._probe_room
    real_batched = svc._probe_state_batched

    def count_full(prep, cache, device_index):
        full.append(cache)
        return real_full(prep, cache, device_index)

    def count_probe(prep, cache, device_index):
        probes.append(cache)
        return real_probe(prep, cache, device_index)

    def count_batched(device_index):
        batched.append(device_index)
        return real_batched(device_index)

    monkeypatch.setattr(svc, "_compute_room", count_full)
    monkeypatch.setattr(svc, "_probe_room", count_probe)
    monkeypatch.setattr(svc, "_probe_state_batched", count_batched)
    out = svc.localize(img, room="auto")
    assert out["room"] == "checker"
    assert set(out["room_scores"]) == {"plain", "checker"}
    assert out["room_scores"]["checker"] < out["room_scores"]["plain"]
    assert np.linalg.norm(out["t"] - gt_t) < 0.2
    assert out["room_scores"]["checker"] == out["loss"]
    if mode is False:
        assert len(full) == 2 and probes == [] and batched == []
    else:  # the probe rules the plain room out: one full query
        assert full == [svc._rooms["checker"][0]]
        # True: a probe per room; "batched": one probe over both rooms
        assert (len(probes), len(batched)) == ((2, 0) if mode is True
                                               else (0, 1))
    assert "room_scores" not in svc.localize(img, room="checker")


def test_batched_probe_mode_is_the_per_room_probe(scene, plain_room):
    """room_auto_probe = "batched" is the per-room probe, bit for bit, only
    where the JAX package makes it so: under colour prep, with a one-time
    warning.  Without colour prep it is the one-program probe: one
    ``probe.probe_rooms`` over both rooms, whose losses are the room scores
    of the rooms it rules out, and the same pick as the per-room probe."""
    from piccolo_tpu_torch.probe import probe_rooms

    xyz, rgb, img, _ = scene
    outs = []
    for mode in (True, "batched"):
        svc = _svc(max_rooms=2, room_auto_probe=mode, match_color=True)
        svc.load_room(*plain_room, name="plain")
        svc.load_room(xyz, rgb, name="checker")
        if mode == "batched":
            with pytest.warns(UserWarning, match="per-room probe"):
                outs.append(svc.localize(img, room="auto"))
            with warnings.catch_warnings():
                warnings.simplefilter("error")  # warned once only
                svc.localize(img, room="auto")
        else:
            outs.append(svc.localize(img, room="auto"))
    assert outs[0]["room"] == outs[1]["room"] == "checker"
    assert outs[0]["room_scores"] == outs[1]["room_scores"]
    np.testing.assert_array_equal(outs[0]["t"], outs[1]["t"])

    svc = _svc(max_rooms=2, room_auto_probe="batched", room_auto_margin=1.0)
    svc.load_room(*plain_room, name="plain")
    svc.load_room(xyz, rgb, name="checker")
    calls = []
    real = probe_rooms

    def count(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    import piccolo_tpu_torch.probe as probe_mod

    probe_mod.probe_rooms = count
    try:
        out = svc.localize(img, room="auto")
    finally:
        probe_mod.probe_rooms = real
    st = svc._probe_state_batched(0)
    assert calls == [st.xyz.shape] and st.names == ("plain", "checker")
    want = st.losses(svc._prepare(img, svc._rooms["plain"][0])[0],
                     **svc._probe_kwargs())
    assert out["room"] == "checker"
    assert out["room_scores"]["plain"] == float(want[0])
    assert out["room_scores"]["checker"] == out["loss"]


def test_room_probe_ranks_like_jax(scene, plain_room):
    """The per-room probe (``_run_fused(probe=True)``: stages 1 and 2, then
    a short pruned descent at the init resolution) of both packages on the
    same rooms and image: the same ranking, losses within 1e-3 (a
    20-iteration descent at lr 0.01, summed in another order; the prune
    midway keeps starts by their loss, and here the two packages end 4.7e-4
    apart on the plain room, 9e-5 on the checker room)."""
    from piccolo_tpu.serve import LocalizeService as JaxService

    xyz, rgb, img, _ = scene
    cfg = dict(_CFG, room_auto_probe=True, room_auto_probe_iters=20)
    losses = []
    port = LocalizeService(max_rooms=2, device="cpu", **cfg)
    for svc in (port, JaxService(max_rooms=2, **cfg)):
        svc.load_room(*plain_room, name="plain")
        svc.load_room(xyz, rgb, name="checker")
        got = []
        for name in ("plain", "checker"):
            cache = svc._rooms[name][0]
            # the port's probe takes a request's prep as the host left it
            prep = (svc._prep_head(img, cache) if svc is port
                    else svc._prepare(img, cache))
            got.append(svc._probe_room(prep, cache, 0))
        losses.append(np.float32(got))
    got, want = losses
    assert got[1] < got[0] and want[1] < want[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_tracking_path(scene):
    from piccolo_tpu_torch.tracking import ypr_from_rot

    xyz, rgb, img, gt_t = scene
    svc = _svc()
    svc.load_room(xyz, rgb, name="box")
    out0 = svc.localize(img)
    assert "tracked" not in out0
    gt1 = gt_t + np.float32([0.03, -0.02, 0.01])
    img1 = render_at(xyz, rgb, gt1, np.float32([0.92, 0, 0]), (128, 256),
                     device="cpu").numpy()
    prev = {"t": out0["t"].tolist(), "ypr": ypr_from_rot(out0["rot"]).tolist()}
    out1 = svc.localize(img1, prev_pose=prev)
    assert out1["tracked"] and not out1.get("recovered")
    assert np.linalg.norm(out1["t"] - gt1) < 0.05
    assert out1["cand_loss"].shape == (1,)
    # a teleported frame with a recovery threshold: the full pipeline
    gt2 = np.float32([-1.6, 1.1, -0.3])
    img2 = render_at(xyz, rgb, gt2, np.float32([3.0, 0, 0]), (128, 256),
                     device="cpu").numpy()
    out2 = svc.localize(img2, prev_pose={"t": out1["t"].tolist(),
                                         "ypr": out1["ypr"].tolist()},
                        recover_above=float(out1["loss"]) * 3.0)
    assert out2["tracked"] and out2["recovered"] and "ypr" in out2
    assert np.linalg.norm(out2["t"] - gt2) < 0.2
    with pytest.raises(ValueError, match="auto"):
        svc.localize(img1, room="auto", prev_pose=prev)
    with pytest.raises(ValueError, match="non-finite"):
        svc.localize(img1, prev_pose={"t": [np.nan, 0, 0], "ypr": [0, 0, 0]})

    # track_batch: a tracked request with nothing queued beside it runs on
    # its own and answers as without it
    batched = _svc(track_batch=True, track_max_batch=4)
    batched.load_room(xyz, rgb, name="box")
    got = batched.localize(img1, prev_pose=prev)
    assert "batched" not in got
    for k in ("t", "rot", "ypr", "cand_loss"):
        np.testing.assert_array_equal(got[k], out1[k])


@pytest.mark.parametrize("track_batch", [False, True])
def test_tracked_request_under_sharpen_color(scene, track_batch):
    """A tracked request under ``sharpen_color`` runs alone, with
    ``track_batch`` off and on, on its own rebound cloud colours: bit for
    bit ``tracking.track_step_fetched`` on ``svc._prepare``'s main image
    and ``rgb_used``, with no ``"batched"``."""
    from piccolo_tpu_torch.tracking import track_step_fetched

    xyz, rgb, _, gt_t = scene
    svc = _svc(sharpen_color=True, track_batch=track_batch,
               track_max_batch=4)
    svc.load_room(xyz, rgb, name="box")
    frame = (render_at(xyz, rgb, gt_t + np.float32([0.03, -0.02, 0.01]),
                       np.float32([0.92, 0, 0]), (128, 256),
                       device="cpu").numpy() * 255).astype(np.uint8)
    prev = {"t": gt_t.tolist(), "ypr": [0.9, 0.0, 0.0]}
    out = svc.localize(frame, prev_pose=prev)
    assert out["tracked"] and "batched" not in out
    cache = svc._rooms["box"][0]
    _, main, rgb_used, _ = svc._prepare(frame, cache)
    assert rgb_used is not cache["rgb"]
    t0, y0 = svc._parse_prev_pose(prev)
    t, ypr, rot, loss = track_step_fetched(
        main, cache["xyz"], rgb_used, t0, y0, cache["lo"], cache["hi"],
        cache["mask"], **svc._track_kw(cache))
    np.testing.assert_array_equal(out["t"], t)
    np.testing.assert_array_equal(out["ypr"], ypr)
    np.testing.assert_array_equal(out["rot"], rot)
    assert out["loss"] == loss
    assert not svc._track_queues[0]


def test_track_batch_drains_concurrent_requests(scene):
    """Three tracked requests queued while the device is held are drained
    as ONE batch by the first to take the compute lock (padded to 4 by
    repeating the last stream): each answer carries ``"batched": 3``,
    equals ``track_steps_batched`` on the same frames bit for bit, and
    equals its own single request within 1e-4 m, 1e-4 rad and a relative
    1e-4 of the loss (the batch's backward adds a stream's gradient terms
    in another order: test_torch_tracking.py)."""
    from piccolo_tpu_torch.tracking import track_steps_batched, ypr_from_rot

    xyz, rgb, img, gt_t = scene
    svc = _svc(track_batch=True, track_max_batch=4)
    svc.load_room(xyz, rgb, name="box")
    out0 = svc.localize(img)
    prev = {"t": out0["t"].tolist(), "ypr": ypr_from_rot(out0["rot"]).tolist()}
    steps = [np.float32([0.03, -0.02, 0.01]), np.float32([-0.02, 0.03, 0.0]),
             np.float32([0.01, 0.01, -0.02])]
    frames = [render_at(xyz, rgb, gt_t + d, np.float32([0.92, 0, 0]),
                        (128, 256), device="cpu").numpy() for d in steps]
    frames = [(f * 255).astype(np.uint8) for f in frames]
    outs = [None] * 3
    lock = svc._compute_locks[0]
    lock.acquire()
    try:
        threads = [threading.Thread(
            target=lambda i=i: outs.__setitem__(
                i, svc.localize(frames[i], prev_pose=prev)))
            for i in range(3)]
        for th in threads:
            th.start()
        for _ in range(600):
            if len(svc._track_queues[0]) == 3:
                break
            threading.Event().wait(0.05)
        assert len(svc._track_queues[0]) == 3
    finally:
        lock.release()
    for th in threads:
        th.join(300)
    assert [o["batched"] for o in outs] == [3, 3, 3]
    cache = svc._rooms["box"][0]
    mains = [svc._prepare(f, cache)[1] for f in frames]
    t0, y0 = svc._parse_prev_pose(prev)
    want = track_steps_batched(
        np.stack(mains + mains[-1:]), cache["xyz"], cache["rgb"],
        np.stack([t0] * 4), np.stack([y0] * 4), cache["lo"], cache["hi"],
        cache["mask"], **svc._track_kw())
    single = _svc()
    single.load_room(xyz, rgb, name="box")
    for out, w, f in zip(outs, want, frames):
        np.testing.assert_array_equal(out["t"], w[0])
        np.testing.assert_array_equal(out["ypr"], w[1])
        assert out["loss"] == w[3]
        one = single.localize(f, prev_pose=prev)
        assert "batched" not in one
        np.testing.assert_allclose(out["t"], one["t"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(out["ypr"], one["ypr"], rtol=0, atol=1e-4)
        assert abs(out["loss"] - one["loss"]) <= 1e-4 * abs(one["loss"])
    assert not svc._track_queues[0]


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


def test_served_query_spans_one_request(scene):
    """A full served query under a profiler session: one each of the
    service's spans and one descent span, all under one request id, the
    fetch inside the solve; the reply names the route."""
    xyz, rgb, img, _ = scene
    svc = _svc()
    svc.load_room(xyz, rgb, name="box")
    out, recs = _traced(lambda: svc.localize(img))
    (root,) = [r for r in recs if r.name == "service.request"]
    assert root.attrs == {"kind": "query", "device": 0}
    mine = [r for r in recs if r.requests == root.requests]
    names = Counter(r.name for r in mine if r.n is None)
    for name in ("service.request", "service.prep", "service.lock_wait",
                 "service.solve", "service.fetch",
                 "localize.stage3_descent"):
        assert names[name] == 1, name
    by = {r.name: r for r in mine}
    assert by["service.prep"].parent == root.id
    assert by["service.fetch"].parent == by["service.solve"].id
    assert (by["service.lock_wait"].end_ns <= by["service.solve"].start_ns
            <= by["service.solve"].end_ns <= root.end_ns)
    assert out["route"] == "stage 1 gather engine, stage 2 live splat"


def test_track_batch_spans_name_both_requests(scene):
    """Two tracked frames queued while the device is held are answered
    by one batch: one ``track.batch`` over both request ids with one
    descent span inside it, and a queue wait for each frame."""
    from piccolo_tpu_torch.tracking import ypr_from_rot

    xyz, rgb, img, gt_t = scene
    svc = _svc(track_batch=True, track_max_batch=4)
    svc.load_room(xyz, rgb, name="box")
    out0 = svc.localize(img)
    prev = {"t": out0["t"].tolist(), "ypr": ypr_from_rot(out0["rot"]).tolist()}
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
        finally:
            lock.release()
        for th in threads:
            th.join(300)
        assert not any(th.is_alive() for th in threads)

    _, recs = _traced(two_frames)
    assert [o["batched"] for o in outs] == [2, 2]
    roots = [r for r in recs if r.name == "service.request"]
    assert sorted(r.attrs["kind"] for r in roots) == ["tracked", "tracked"]
    ids = sorted(r.requests[0] for r in roots)
    (batch,) = [r for r in recs if r.name == "track.batch"]
    assert sorted(batch.requests) == ids
    assert batch.attrs == {"k": 2, "bucket": 2}
    (descent,) = [r for r in recs if r.name == "localize.stage3_descent"]
    assert descent.parent == batch.id and descent.requests == batch.requests
    for name in ("track.upload", "service.fetch"):
        (sp,) = [r for r in recs if r.name == name]
        assert sp.parent == batch.id
    waits = [r for r in recs if r.name == "track.queue_wait"]
    assert sorted(w.requests[0] for w in waits) == ids
    for w in waits:
        assert w.parent == batch.id and w.start_ns <= w.end_ns
        assert w.end_ns <= batch.end_ns
    assert len([r for r in recs if r.name == "service.lock_wait"]) == 2


@pytest.mark.parametrize("slab_init", [True, False])
def test_stage1_pair_counters(scene, slab_init):
    """``stage1.pairs_planned`` counts every real pair with a whole slab
    plan and none with plans off; both name the query's request."""
    xyz, rgb, img, _ = scene
    svc = _svc(slab_init=slab_init)
    svc.load_room(xyz, rgb, name="box")
    out, recs = _traced(lambda: svc.localize(img))
    (root,) = [r for r in recs if r.name == "service.request"]
    got = {r.name: r.n for r in recs if r.n is not None}
    assert all(r.requests == root.requests for r in recs if r.n is not None)
    grids = svc._rooms["box"][0]["grids"]
    pairs = grids.n_trans * int(grids.rot.shape[0])
    assert got["stage1.pairs"] == pairs > 0
    assert got["stage1.pairs_planned"] == (pairs if slab_init else 0)
    assert out["route"].startswith(
        "stage 1 f32 slab plan," if slab_init else "stage 1 gather engine,")


@pytest.mark.parametrize("kw,err,match", [
    (dict(fused=False), ValueError, "fused pipeline only"),
    (dict(sample_rate_for_init=2), ValueError, "fused pipeline only"),
    (dict(visualize=True), ValueError, "per-iteration"),
    # query_devices runs since the multi-device slice; what stays refused
    # is its combination with n_devices (the case keeps its id)
    pytest.param(dict(query_devices=2, n_devices=2), ValueError,
                 "mutually exclusive",
                 id="kw3-NotImplementedError-multi-device slice"),
    # exec_cache_dir runs since the executable-cache slice: the service
    # builds its JPEG codec into the cache (the case keeps its id)
    pytest.param(dict(exec_cache_dir="{tmp}"), None, "",
                 id="kw4-NotImplementedError-executable-cache slice"),
])
def test_refused_configs(kw, err, match, tmp_path, library_store):
    if err is None:
        kw = {k: v.format(tmp=tmp_path) for k, v in kw.items()}
        svc = _svc(**kw)
        assert svc.exec_cache["dir"] == str(tmp_path.resolve())
        assert any(n.startswith("jpeg_codec-") for n in svc.exec_cache["built"]
                   + svc.exec_cache["hits"])
        return
    with pytest.raises(err, match=match):
        _svc(**kw)


def test_service_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalizeService(**_CFG)


def test_serve_main_parses_device_and_refuses_exec_cache(tmp_path,
                                                         monkeypatch,
                                                         library_store,
                                                         capsys):
    """The service's CLI parses --device, and --exec-cache (refused before
    the executable-cache slice) loads its libraries from the cache before
    it serves."""
    from piccolo_tpu_torch import serve
    from piccolo_tpu_torch.serve import build_parser, main

    ini = tmp_path / "cfg.ini"
    ini.write_text("[Default]\ndataset = Stanford2D-3D-S\n")
    args = build_parser().parse_args(["--config", str(ini), "--device", "cpu"])
    assert args.device == "cpu" and args.port == 8321
    served = []
    monkeypatch.setattr(serve, "serve_forever",
                        lambda svc, *a, **k: served.append(svc))
    main(["--config", str(ini), "--device", "cpu", "--exec-cache",
          str(tmp_path / "exec")])
    assert len(served) == 1
    assert served[0].exec_cache["dir"] == str((tmp_path / "exec").resolve())
    assert "exec cache: " in capsys.readouterr().out


def test_query_devices_answer_in_turn(scene):
    """Two query replicas answer requests in turn (warmed at load, each
    under its own compute lock), each bit-equal to one device's answer."""
    xyz, rgb, img, _ = scene
    one = LocalizeService(device="cpu", **_CFG)
    one.load_room(xyz, rgb, name="box")
    want = one.localize(img)
    svc = LocalizeService(device="cpu", query_devices=2, **_CFG)
    assert svc.devices == 2 and len(svc._compute_locks) == 2
    svc.load_room(xyz, rgb, name="box", warm_shape=(32, 64))
    assert len(svc._rooms["box"]) == 2
    outs = [svc.localize(img) for _ in range(3)]
    # the warm-up pins each device and leaves the turn order alone
    assert [o["device_index"] for o in outs] == [0, 1, 0]
    for o in outs:
        np.testing.assert_array_equal(o["t"], want["t"])
        np.testing.assert_array_equal(o["cand_loss"], want["cand_loss"])


def test_n_devices_request_runs_on_the_mesh(scene):
    """n_devices = 4: a 2 x 2 mesh of logical CPU shards answers a request
    bit-equal to _run_fused over that mesh, and within 1e-3 m of the
    single-device service (the sums add in another order)."""
    from piccolo_tpu_torch.harness.localize import _run_fused

    xyz, rgb, img, _ = scene
    svc = LocalizeService(device="cpu", n_devices=4, **_CFG)
    assert svc.mesh.shape == {"cand": 2, "point": 2} and svc.devices == 1
    svc.load_room(xyz, rgb, name="box")
    out = svc.localize(img)
    cache = svc._rooms["box"][0]
    img_init, img_main, rgb_used, _ = svc._prepare(img, cache)
    res, route = _run_fused(img_init, img_main, cache, rgb_used, svc.cfg,
                            svc.init_dict, cache["grids"], svc.mesh,
                            sync_plans=True)
    assert route.startswith("mesh 2x2")
    np.testing.assert_array_equal(out["t"], res.t.numpy())
    np.testing.assert_array_equal(out["cand_loss"], res.cand_loss.numpy())
    one = LocalizeService(device="cpu", **_CFG)
    one.load_room(xyz, rgb, name="box")
    want = one.localize(img)
    assert out["winner"] == want["winner"]
    assert np.abs(out["t"] - want["t"]).max() < 1e-3


def test_budget_counts_sharded_plans_per_card(scene, plain_room):
    """Under n_devices the plan budget is per card: another room's sharded
    plans count what their busiest card holds, not their sum over the
    mesh (a two-room service on a CPU mesh, then sharded plans on two
    cards)."""
    from piccolo_tpu_torch.config import cfg_get
    from piccolo_tpu_torch.parallel import ShardedGridPlan

    xyz, rgb, img, _ = scene
    svc = LocalizeService(device="cpu", n_devices=4, max_rooms=2,
                          slab_init=True, slab_bytes_cap=2**40, **_CFG)
    svc.load_room(xyz, rgb, name="a")
    svc.load_room(*plain_room, name="b")
    svc.localize(img, room="a")
    cache_a, cache_b = svc._rooms["a"][0], svc._rooms["b"][0]
    sharded = [v for k, v in cache_a.items() if isinstance(k, tuple)
               and k[0] == "slab_plan_sharded"]
    assert len(sharded) == 1 and sharded[0].card_bytes == {
        "cpu": sharded[0].nbytes}  # every shard of this mesh is on the CPU
    assert svc._resident_plan_bytes(cache_b, 0) == sharded[0].nbytes

    def on_two_cards(n):
        return ShardedGridPlan([], 0, 64, 128, False, 8, 128, False, False,
                               False, ("cuda:0", "cuda:1"),
                               {"cuda:0": n, "cuda:1": n})

    class TwoCardPlanes:  # a ShardedHistPlan's view of its cards
        card_bytes = {"cuda:0": 100, "cuda:1": 50}

    svc = _svc(max_rooms=2, slab_bytes_cap=1000)
    svc.load_room(xyz, rgb, name="a")
    svc.load_room(*plain_room, name="b")
    cache_a, cache_b = svc._rooms["a"][0], svc._rooms["b"][0]
    cache_a[("slab_plan_sharded", 64, 128)] = on_two_cards(300)
    assert cfg_get(svc._budget_cfg(cache_b, 0), "slab_bytes_cap") == 700
    cache_a[("hist_plan_sharded", 64, 128)] = TwoCardPlanes()
    assert cfg_get(svc._budget_cfg(cache_b, 0), "slab_bytes_cap") == 600
    cache_a[("slab_plan", 64, 128)] = type("OnTheCpu", (), {"nbytes": 800})()
    assert cfg_get(svc._budget_cfg(cache_b, 0), "slab_bytes_cap") == 200
