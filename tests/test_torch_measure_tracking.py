"""The port's tracking measurement script (``scripts/measure_tracking_cuda.py``) against
the JAX package's (``scripts/measure_tracking.py``, loaded unedited), on
the CPU.

  * Inputs, bit for bit: with the full pipeline, the tracker and the
    renderer replaced by recorders, both scripts render the same
    ground-truth poses (default, ``--teleport``, ``--teleport-every 5``)
    and give the seed query the same cloud, grids, mask and box; and the
    two packages' ``raycast_pano`` render the first frames alike.
  * One real run of each ``main`` at ``--frames 20 --teleport --height 32
    --points 3000 --num-iter 5`` (twenty frames, so that the divergence
    gate's window of 8 accepted losses fills before the teleport at frame
    10): the same summary keys (the port adds ``device``), the same
    recovery frames, and each frame's t_err within ``T_ERR_BOUND`` of the
    JAX run's.  The seed and recovery queries descend at lr 0.1, where the
    two frameworks' last bits part (ROADMAP Queue 3), so poses are not
    held bit for bit.
"""

import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

import piccolo_tpu.testing as jtesting
from piccolo_tpu_torch import testing as ttesting

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RUN = ["--frames", "20", "--teleport", "--height", "32", "--points", "3000",
       "--num-iter", "5"]
# per-frame t_err of the two real runs.  Their inputs are bit-equal, but
# the lr 0.1 seed descent lands 1.5 mm apart (13.8 and 15.3 mm from the
# truth) and the tracked frames carry that on at 32x64, where a pixel
# spans 5.6 degrees: poses drift up to 61 mm apart, t_err up to 22.7 mm
# (ROADMAP Queue 3), every frame of both runs 10-75 mm from the truth
T_ERR_BOUND = 0.03
# and every frame of both within the OmniScenes criterion's 0.1 m
T_ERR_MAX = 0.1


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jscript():
    return _load("jax_measure_tracking", "scripts/measure_tracking.py")


@pytest.fixture(scope="module")
def tscript():
    return _load("port_measure_tracking", "scripts/measure_tracking_cuda.py")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _record_inputs(mod, monkeypatch, port):
    """Replace the script's renderer, full pipeline and tracker by
    recorders: the poses it renders and the seed query's arguments."""
    rec = dict(poses=[], query=None)

    def raycast(scene, t, ypr, res):
        rec["poses"].append((np.array(t, copy=True), np.array(ypr, copy=True)))
        return np.zeros(tuple(res) + (3,), np.float32)

    def query(*args, **kw):
        if rec["query"] is None:
            rec["query"] = ([_np(a) for a in args[2:]], kw)
        z = torch.zeros if port else np.zeros
        return types.SimpleNamespace(t=z(3), cand_ypr=z((6, 3)), winner=0)

    class Tracker:
        def __init__(self, *a, **kw):
            pass

        def update(self, img):
            return types.SimpleNamespace(t=np.zeros(3, np.float32),
                                         recovered=False, lost=False)

    monkeypatch.setattr(mod, "raycast_pano", raycast)
    monkeypatch.setattr(mod, "localize_query", query)
    monkeypatch.setattr(mod, "Tracker", Tracker)
    return rec


@pytest.mark.parametrize("extra", [[], ["--teleport"],
                                   ["--teleport-every", "5"]],
                         ids=["default", "teleport", "teleport-every"])
def test_ground_truth_and_seed_inputs_bit_for_bit(jscript, tscript,
                                                  monkeypatch, extra):
    argv = ["--frames", "14", "--height", "16", "--points", "2000"] + extra
    want = _record_inputs(jscript, monkeypatch, port=False)
    jscript.main(argv)
    got = _record_inputs(tscript, monkeypatch, port=True)
    tscript.main(argv + ["--device", "cpu"])
    assert len(got["poses"]) == len(want["poses"]) == 14
    for (gt, gy), (wt, wy) in zip(got["poses"], want["poses"]):
        assert gt.dtype == wt.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gy, wy)
    # cloud, rgb, grids, validity, box and mask of the seed query
    g_args, g_kw = got["query"]
    w_args, w_kw = want["query"]
    assert len(g_args) == len(w_args) == 8
    for g, w in zip(g_args, w_args):
        np.testing.assert_array_equal(g, w)
    g_kw = {k: v for k, v in g_kw.items() if k != "device"}
    assert g_kw == w_kw


def test_first_frames_render_alike(jscript, tscript):
    """The two packages' ray-cast renderer on the run's first poses."""
    rng = np.random.default_rng(3)
    scene = jtesting.make_scene(rng, size=(6.0, 4.0, 3.0), n_occluders=2,
                                texture="checker")
    ts, yprs = tscript.ground_truth(4, rng, teleport=True)
    for t, ypr in zip(ts, yprs):
        want = jtesting.raycast_pano(scene, t, ypr, (24, 48))
        got = ttesting.raycast_pano(scene, t, ypr, (24, 48))
        np.testing.assert_array_equal(got, want)


def _recording_tracker(mod, monkeypatch, frames):
    real = mod.Tracker

    class Tracker(real):
        def update(self, img):
            out = real.update(self, img)
            frames.append(np.asarray(out.t, np.float64))
            return out

    monkeypatch.setattr(mod, "Tracker", Tracker)


@pytest.fixture(scope="module")
def runs(jscript, tscript):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for key, mod, argv in (("jax", jscript, RUN),
                               ("port", tscript, RUN + ["--device", "cpu"])):
            frames = []
            _recording_tracker(mod, mp, frames)
            out[key] = (mod.main(argv), frames)
    return out


def test_real_runs_agree(jscript, tscript, runs):
    (want, w_frames), (got, g_frames) = runs["jax"], runs["port"]
    assert set(got) - {"device"} == set(want)
    assert got["device"] == "cpu"
    assert got["recovered_at"] == want["recovered_at"] == [10]
    assert got["n_recoveries"] == want["n_recoveries"] == 1
    assert got["frames"] == want["frames"] == 19
    assert len(got["full_pipeline_s"]) == len(want["full_pipeline_s"]) == 2
    rng = np.random.default_rng(3)
    scene = jtesting.make_scene(rng, size=(6.0, 4.0, 3.0), n_occluders=2,
                                texture="checker")
    jtesting.scene_cloud(scene, rng, 3000)
    ts, _ = tscript.ground_truth(20, rng, teleport=True)
    g_err = np.array([np.linalg.norm(t - gt) for t, gt in zip(g_frames, ts[1:])])
    w_err = np.array([np.linalg.norm(t - gt) for t, gt in zip(w_frames, ts[1:])])
    assert len(g_err) == len(w_err) == 19
    np.testing.assert_allclose(g_err, w_err, rtol=0, atol=T_ERR_BOUND)
    assert g_err.max() < T_ERR_MAX and w_err.max() < T_ERR_MAX
    np.testing.assert_allclose(got["median_t_err_mm"],
                               float(np.median(g_err) * 1000), rtol=1e-6)
