"""The port's ops, utils, realism scenes and GIF writer against the JAX
package and PIL, on the CPU.

  * ``ops``: the JAX package's export list; ``warp_from_img`` within the
    JAX test's 2e-6 of ``piccolo_tpu.ops.warp_from_img`` (both sample with
    f32 arithmetic in their own order); ``pose_search_bounds`` and
    ``out_of_room`` equal to the JAX functions (host order statistics).
  * ``testing``'s realism scenes bit-equal to ``piccolo_tpu.testing``'s from
    one seed (numpy host code; the jpeg arm through the port's codec
    against cv2's libjpeg).
  * ``harness/gif.py``: PIL decodes every frame to the quantized input,
    with the duration and the loop; ``save_gif`` keeps the reference's
    frame padding.
  * ``utils``: ``maybe_trace`` (off without a directory; a profiled query
    gives the same bits as an unprofiled one), the span store (off: nothing
    recorded and no profiler range; on: a span on another thread
    stored with its request id and parent, on the profiler's clock),
    ``enable_nan_debug``, ``enable_compilation_cache`` and the CLI's
    ``compilation_cache`` keys, ``debug_visualize``.
"""

import io
import os
import sys
import threading
import time

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

import piccolo_tpu.ops as jops  # noqa: E402
import piccolo_tpu.testing as jtesting  # noqa: E402
import piccolo_tpu_torch.ops as tops  # noqa: E402
import piccolo_tpu_torch.testing as ttesting  # noqa: E402
from piccolo_tpu_torch.harness import gif  # noqa: E402
from piccolo_tpu_torch.harness.outputs import save_gif  # noqa: E402
from piccolo_tpu_torch.kernels import _build  # noqa: E402
from piccolo_tpu_torch.utils import (  # noqa: E402
    enable_compilation_cache,
    enable_nan_debug,
    maybe_trace,
    profiling,
)

torch.set_num_threads(2)


@pytest.fixture
def library_store():
    """Restore the process's library store after a test that moves it."""
    store = _build.library_store()
    yield
    _build.use_store(store)


# ---------------------------------------------------------------------------
# ops


def test_ops_export_the_jax_list():
    assert sorted(tops.__all__) == sorted(jops.__all__)
    assert all(callable(getattr(tops, n)) for n in tops.__all__)


@pytest.mark.parametrize("src,out", [((20, 40, 3), (8, 16)),
                                     ((7, 13, 1), (5, 3)),
                                     ((32, 64, 4), (32, 64))])
def test_warp_from_img_matches_jax(src, out):
    rng = np.random.default_rng(sum(src) + sum(out))
    img = rng.random(src).astype(np.float32)
    grid = (rng.random(out + (2,)).astype(np.float32) * 2.2) - 1.1
    want = np.asarray(jops.warp_from_img(jnp.asarray(img), jnp.asarray(grid)))
    got = tops.warp_from_img(torch.from_numpy(img), torch.from_numpy(grid))
    assert got.shape == out + (src[2],)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("q", [0.05, 0.1])
def test_pose_search_bounds_and_out_of_room_match_jax(q):
    rng = np.random.default_rng(3)
    xyz = (rng.random((2000, 3)) * [6, 4, 3] - [3, 2, 0]).astype(np.float32)
    for kw in (dict(), dict(as_slices=True), dict(yaw=(0.5, 1.5))):
        assert (tops.pose_search_bounds(xyz, q, **kw)
                == jops.pose_search_bounds(xyz, q, **kw))
    # a tensor argument is copied to the host first
    assert (tops.pose_search_bounds(torch.from_numpy(xyz), q)
            == jops.pose_search_bounds(xyz, q))
    for t in ([0.0, 0.0, 1.5], [2.99, 0.0, 1.5], [0.0, -2.5, 1.5],
              [0.0, 0.0, 0.01]):
        t = np.float32(t)
        assert tops.out_of_room(xyz, t, q) == jops.out_of_room(xyz, t, q)


# ---------------------------------------------------------------------------
# realism scenes


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_cluttered_room_and_free_pose_bit_equal(seed):
    kw = dict(n_per_wall=600, n_occluders=seed % 4, n_per_occluder=300)
    want = jtesting.make_cluttered_room(np.random.default_rng(seed), **kw)
    got = ttesting.make_cluttered_room(np.random.default_rng(seed), **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for yaw_only in (True, False):
        w = jtesting.pose_outside_occluders(np.random.default_rng(seed + 9),
                                            want[2], yaw_only=yaw_only)
        g = ttesting.pose_outside_occluders(np.random.default_rng(seed + 9),
                                            got[2], yaw_only=yaw_only)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def capture():
    xyz, rgb = ttesting.make_room(np.random.default_rng(1), n_per_wall=3000)
    t, ypr = ttesting.random_pose_inside(np.random.default_rng(2))
    img = ttesting.render_at(xyz, rgb, t, ypr, (64, 128), device="cpu")
    return xyz, rgb, (img.numpy() * 255).round().astype(np.uint8)


@pytest.mark.parametrize("arm,val", [("noise", 0.02), ("jpeg", 60),
                                     ("jpeg", 95), ("blur", 9),
                                     ("vignette", 0.4)])
def test_image_realism_bit_equal(capture, arm, val):
    _, _, img = capture
    want = jtesting.apply_image_realism(img, arm, val,
                                        np.random.default_rng(5))
    got = ttesting.apply_image_realism(img, arm, val,
                                       np.random.default_rng(5))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arm,val", [("depth-noise", 0.01), ("holes", 0.1)])
def test_cloud_realism_bit_equal(capture, arm, val):
    xyz, rgb, _ = capture
    want = jtesting.apply_cloud_realism(xyz, rgb, arm, val,
                                        np.random.default_rng(5))
    got = ttesting.apply_cloud_realism(xyz, rgb, arm, val,
                                       np.random.default_rng(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_realism_refuses_unknown_arms(capture):
    xyz, rgb, img = capture
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="unknown image realism arm"):
        ttesting.apply_image_realism(img, "fog", 1.0, rng)
    with pytest.raises(ValueError, match="uint8"):
        ttesting.apply_image_realism(img.astype(np.float32), "noise", 1, rng)
    with pytest.raises(ValueError, match="unknown cloud realism arm"):
        ttesting.apply_cloud_realism(xyz, rgb, "dust", 1.0, rng)


# ---------------------------------------------------------------------------
# the GIF writer


def _pil_frames(data: bytes):
    im = Image.open(io.BytesIO(data))
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration"))
    return frames, durations, im.info.get("loop")


@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (64, 96), (97, 130)])
def test_gif_decodes_to_the_quantized_frames(capture, h, w):
    """Random frames (every pixel a new code, through the 4,096-code table
    reset), flat ones (long runs) and a render, each decoded by PIL to
    ``PALETTE[quantize(frame)]``."""
    rng = np.random.default_rng(h * w)
    render = capture[2]
    frames = [
        rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        np.full((h, w, 3), 200, np.uint8),
        np.ascontiguousarray(np.resize(render, (h, w, 3))),
    ]
    got, durations, loop = _pil_frames(gif.encode_gif(frames, 70))
    assert len(got) == len(frames)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, gif.PALETTE[gif.quantize(f)])
    assert durations == [70] * len(frames) and loop == 0


def test_gif_palette_and_quantizer():
    assert gif.PALETTE.shape == (256, 3) and gif.PALETTE.dtype == np.uint8
    assert len({tuple(c) for c in gif.PALETTE}) == 256
    levels = np.arange(256, dtype=np.uint8)
    f = np.stack([levels] * 3, -1)[None]
    q = gif.PALETTE[gif.quantize(f)][0].astype(int)
    # each channel to its nearest level: within half a level step
    assert (np.abs(q[:, :2] - levels[:, None]) <= 255 / 7 / 2 + 0.5).all()
    assert (np.abs(q[:, 2] - levels) <= 255 / 3 / 2 + 0.5).all()
    with pytest.raises(ValueError, match="uint8"):
        gif.quantize(f.astype(np.float32))
    with pytest.raises(ValueError, match="first's size"):
        gif.encode_gif([f, f[:, :10]])


def test_save_gif_keeps_the_reference_padding(tmp_path):
    """4 leading copies of the first frame, the frames, 5 hold frames of the
    last (PIL's own writer merges repeats; this one writes them all)."""
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
              for _ in range(3)]
    path = str(tmp_path / "gifs" / "q.gif")
    save_gif(path, frames, duration_ms=150)
    with open(path, "rb") as f:
        got, durations, _ = _pil_frames(f.read())
    want = frames[:1] * 4 + frames + frames[-1:] * 5
    assert len(got) == len(want) == 12
    for g, f in zip(got, want):
        np.testing.assert_array_equal(g, gif.PALETTE[gif.quantize(f)])
    assert durations == [150] * 12


# ---------------------------------------------------------------------------
# utils


def test_timer_and_trace_off():
    with maybe_trace(None) as prof:
        assert prof is None
    with maybe_trace("") as prof:
        assert prof is None


def test_span_off_records_nothing(monkeypatch):
    """With no profiler session a span, request, counter or record stores
    nothing and opens no profiler range."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not profiling.tracing()
    t0 = time.time_ns()
    with profiling.request("test.request", kind="query"):
        with profiling.span("test.span", k=1):
            profiling.count("test.count", 3)
            profiling.record("test.wait", t0, t0 + 1)
            assert profiling.current_requests() == ()
    assert profiling.span("a") is profiling.span("b", k=2)
    assert profiling.span_records(t0, time.time_ns()) == []


def _all_threads_profile():
    """A CPU profiler session that records every thread where the
    installed PyTorch can."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    return profile(activities=[ProfilerActivity.CPU], **kw)


def test_span_on_records_a_second_thread():
    """A session opened on this thread turns spans on for another: the
    child span carries the root's request id and names it as parent, and
    both stamps lie within 1 ms of the profiler's own events."""
    def work():
        with profiling.request("test.request", kind="query"):
            with profiling.span("test.child", k=1):
                profiling.count("test.count", 3)
                time.sleep(0.002)

    t0 = time.time_ns()
    with _all_threads_profile() as prof:
        th = threading.Thread(target=work)
        th.start()
        th.join(30)
    assert not th.is_alive() and not profiling.tracing()
    recs = {r.name: r for r in profiling.span_records(t0, time.time_ns())}
    root, child, n = (recs["test.request"], recs["test.child"],
                      recs["test.count"])
    assert len(root.requests) == 1 and root.parent is None
    assert child.requests == n.requests == root.requests
    assert child.parent == root.id and n.parent == child.id
    assert root.attrs == {"kind": "query"} and child.attrs == {"k": 1}
    assert n.n == 3 and child.n is None
    assert child.thread == root.thread != threading.get_ident()
    assert root.start_ns <= child.start_ns <= child.end_ns <= root.end_ns
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in recs}
    for r in (root, child):
        e = events[r.name]
        assert abs(e.start_ns() - r.start_ns) < 1_000_000
        assert abs(e.end_ns() - r.end_ns) < 1_000_000


def test_profiled_query_has_the_unprofiled_bits(tmp_path):
    """localize_query on the CPU under maybe_trace: one trace file, the
    profile records the query's stage spans, and the same winner and pose
    bits as without it."""
    from piccolo_tpu_torch import localize_query
    from piccolo_tpu_torch.harness.localize import _order_bounds, _pad_cloud
    from piccolo_tpu_torch.init.candidates import (
        default_init_dict,
        generate_rot_points,
        generate_trans_points,
    )

    xyz, rgb = ttesting.make_room(np.random.default_rng(7), n_per_wall=1500)
    t_gt, ypr_gt = ttesting.random_pose_inside(np.random.default_rng(8))
    img = ttesting.render_at(xyz, rgb, t_gt, ypr_gt, (64, 128), device="cpu")
    xyz_d, rgb_d, mask_d = _pad_cloud(xyz, rgb, "cpu")
    lo, hi = _order_bounds(xyz, 0.05)
    d = default_init_dict(xy_only=True, yaw_only=True, num_yaw=4,
                          num_trans=8, z_prior=None)
    trans = generate_trans_points(xyz, d)
    rot = generate_rot_points(d)
    valid = np.ones(trans.shape[0], bool)

    def query():
        return localize_query(
            img[::2, ::2].contiguous(), img, xyz_d, rgb_d, trans, rot, valid,
            lo, hi, mask_d, num_intermediate=6, num_input=3, num_iter=10,
            lr=0.05, patience=5, factor=0.8, masked=True, device="cpu")

    want = query()
    with maybe_trace(str(tmp_path / "traces"), name="q/0") as prof:
        got = query()
    names = os.listdir(tmp_path / "traces")
    assert len(names) == 1 and names[0].startswith("q_0-")
    assert names[0].endswith(".pt.trace.json")
    assert any(e.key == "localize.stage3_descent" for e in prof.key_averages())
    assert int(got.winner) == int(want.winner)
    torch.testing.assert_close(got.t, want.t, rtol=0, atol=0)
    torch.testing.assert_close(got.cand_loss, want.cand_loss, rtol=0, atol=0)


@pytest.mark.parametrize("warmup_kernels", [0, 256])
def test_cpu_trace_runs_no_warmup(tmp_path, warmup_kernels):
    """Without a card maybe_trace launches no warm-up work: the trace holds
    the block's operators and no maybe_trace.warmup span."""
    with maybe_trace(str(tmp_path), warmup_kernels=warmup_kernels) as prof:
        torch.ones(4).add_(1)
    keys = {e.key for e in prof.key_averages()}
    assert "aten::add_" in keys and "maybe_trace.warmup" not in keys
    assert len(list(tmp_path.glob("query-*.pt.trace.json"))) == 1


def test_enable_nan_debug_switches_anomaly_detection():
    assert not torch.is_anomaly_enabled()
    try:
        enable_nan_debug(True)
        assert torch.is_anomaly_enabled()
    finally:
        enable_nan_debug(False)
    assert not torch.is_anomaly_enabled()


def test_enable_compilation_cache_moves_the_build_dir(tmp_path, monkeypatch,
                                                      library_store):
    monkeypatch.delenv("PICCOLO_TORCH_CACHE_DIR", raising=False)
    monkeypatch.setattr(_build, "fingerprint", lambda cuda: "test")
    assert enable_compilation_cache(str(tmp_path / "a")) == tmp_path / "a"
    assert _build.library_store().path == tmp_path / "a"
    src = _build.CSRC / "block_histogram.cu"
    assert _build._target(src, _build.NVCC_FLAGS).parent == tmp_path / "a"
    monkeypatch.setenv("PICCOLO_TORCH_CACHE_DIR", str(tmp_path / "env"))
    assert enable_compilation_cache() == tmp_path / "env"
    assert enable_compilation_cache(str(tmp_path / "b")) == tmp_path / "b"
    monkeypatch.delenv("PICCOLO_TORCH_CACHE_DIR")
    assert enable_compilation_cache() == _build.BUILD_DIR


@pytest.mark.parametrize("override,where", [
    ("", "default"), ("compilation_cache_dir={tmp}/cc", "dir"),
    ("compilation_cache=False", "own")])
def test_cli_compilation_cache_keys(tmp_path, monkeypatch, library_store,
                                    override, where):
    """main.py honours compilation_cache and compilation_cache_dir: the
    build directory the harness starts with."""
    from piccolo_tpu_torch import main as tmain
    from piccolo_tpu_torch.harness import localize

    monkeypatch.delenv("PICCOLO_TORCH_CACHE_DIR", raising=False)
    seen = []
    monkeypatch.setattr(localize, "localize_stanford",
                        lambda cfg, w, log, device: seen.append(
                            _build.library_store().path))
    ini = tmp_path / "cfg.ini"
    ini.write_text("[Default]\ndataset = Stanford2D-3D-S\n")
    args = ["--config", str(ini), "--log", str(tmp_path / "log"),
            "--no-tensorboard", "--device", "cpu"]
    if override:
        args += ["--override", override.format(tmp=tmp_path)]
    tmain.main(args)
    if where == "default":
        assert seen == [_build.BUILD_DIR]
    elif where == "dir":
        assert seen == [tmp_path / "cc"]
    else:
        assert seen[0].name.startswith("piccolo_build_")
        assert seen[0] not in (_build.BUILD_DIR,)


def test_debug_visualize_shapes_and_without_matplotlib(monkeypatch):
    from piccolo_tpu_torch.utils.debug import debug_visualize

    rng = np.random.default_rng(0)
    for shape in [(8, 8), (8, 8, 3), (8, 8, 1), (8, 8, 4), (2, 8, 8, 3)]:
        assert debug_visualize(rng.random(shape), show=False) is not None
    assert debug_visualize(torch.rand(4, 4, 3) * 255, show=False) is not None
    with pytest.raises(ValueError, match="unsupported shape"):
        debug_visualize(rng.random(5), show=False)
    import matplotlib.pyplot as plt

    plt.close("all")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="matplotlib"):
        debug_visualize(rng.random((4, 4)), show=False)
