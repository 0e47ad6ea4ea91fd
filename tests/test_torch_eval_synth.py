"""The port's synthetic accuracy evaluation (``python -m
piccolo_tpu_torch.eval_synth``) against ``scripts/eval_synth.py``.

  * Input parity: the JAX script, loaded unedited, and the port each run
    with ``localize_query`` and the two plan builders replaced by
    recorders.  Call by call, every array and keyword that reaches
    ``localize_query`` and the builders is equal: bit for bit where both
    sides compute in numpy (clouds, grids, bounds, ray-cast panoramas and
    their colour and realism arms).  A splat panorama is rendered by each
    framework, whose ``atan2`` may part in the last bit (ROADMAP Queue 3),
    so there at least 99.9% of pixels are equal, as the writers' tests
    require, and the cloud colours that --sharpen rebinds from it agree
    within one 8-bit step (at these seeds the splat inputs are bit-equal
    too).
  * One real run of each ``main`` with ``--no-slab``: the same summary
    keys (the port adds ``device``), the same accuracies and success flags
    and per-query t_err within ``T_ERR_BOUND``.  The script's lr 0.1 makes
    the descent amplify ulps (ROADMAP Queue 3), so bits are not held.
  * ``--device cuda`` raises without a card; the command lines agree.
"""

import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import piccolo_tpu.init.refine as jrefine
import piccolo_tpu.kernels.slab_sampling as jslab
from piccolo_tpu_torch import eval_synth as teval

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = ["--points", "3000", "--height", "32"]
RAY = SMALL + ["--oracle", "raycast", "--rooms", "2", "--queries", "2"]
ARMS = {
    # one room of each kind: plain, checker, cluttered
    "splat": SMALL + ["--rooms", "3", "--queries", "1"],
    "full-rot": SMALL + ["--rooms", "1", "--queries", "2", "--full-rot"],
    "raycast": RAY,
    "noise": RAY + ["--realism", "noise"],
    "holes": RAY + ["--realism", "holes"],
    "gamma-match": RAY + ["--perturb", "gamma", "--match-color"],
    "seam-gt": RAY + ["--seam-gt", "--seam-wrap"],
    "floor-ref": RAY + ["--floor-ref"],
    "sharpen": RAY + ["--sharpen"],
    "splat-sharpen": SMALL + ["--rooms", "1", "--queries", "2", "--sharpen"],
    # f32 estimate over the cap, compact under it: a compact plan with
    # point ids for sharpen's re-bake
    "compact": RAY + ["--sharpen", "--slab-cap", "1e8"],
    # nothing fits: no slab plan, no winner-bin planes
    "no-plans": RAY + ["--slab-cap", "1", "--criterion", "loss",
                       "--prune", "30,2", "--descent-table", "auto"],
}
# t_err of the two frameworks' real runs: the script's lr 0.1 descent
# amplifies an ulp of its inputs; 9e-4 m apart at most on this run, where
# every query lands 1.2-1.8 cm from the truth, far inside both criteria
T_ERR_BOUND = 5e-3
POSITIONAL = ("img_init", "img_main", "xyz", "rgb_used", "trans_grid",
              "rot_grid", "trans_valid", "lo", "hi", "mask")


@pytest.fixture(scope="module")
def jscript():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_synth", ROOT / "scripts" / "eval_synth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _Recorder:
    """Stands in for localize_query and the plan builders: records every
    call's arrays and keywords, returns a fixed pose and stub plans."""

    def __init__(self, as_result):
        self.calls, self.builds = [], []
        self._as_result = as_result

    def _build(self, kind, args, kw):
        # arrays (the hist builder takes its point mask by keyword) apart
        # from flags
        arrays = [_np(a) for a in args]
        if "point_mask" in kw:
            arrays.append(_np(kw.pop("point_mask")))
        kw = {k: v for k, v in kw.items() if k != "device"}
        self.builds.append((kind, arrays, kw))
        # nbytes enters the winner-bin planes' budget
        return type("Plan", (), dict(ref=len(self.builds) - 1,
                                     nbytes=1 << 20))()

    def grid_plan(self, *args, **kw):
        return self._build("grid", args, kw)

    def hist_plan(self, *args, **kw):
        return self._build("hist", args, kw)

    def localize(self, *args, **kw):
        kw = {k: v for k, v in kw.items() if k != "device"}
        for k in ("plan", "hist_plan"):
            kw[k] = None if kw[k] is None else kw[k].ref
        self.calls.append(([_np(a) for a in args], kw))
        return self._as_result(np.zeros(3, np.float32),
                               np.eye(3, dtype=np.float32))


class _Result:
    def __init__(self, t, rot):
        self.t, self.rot = t, rot


def _record_jax(jscript, monkeypatch, argv):
    rec = _Recorder(_Result)
    monkeypatch.setattr(jscript, "localize_query", rec.localize)
    monkeypatch.setattr(jslab, "build_grid_plan", rec.grid_plan)
    monkeypatch.setattr(jrefine, "build_hist_plan", rec.hist_plan)
    return rec, jscript.main(argv)


def _record_port(monkeypatch, argv):
    rec = _Recorder(lambda t, r: _Result(torch.as_tensor(t),
                                         torch.as_tensor(r)))
    monkeypatch.setattr(teval, "localize_query", rec.localize)
    monkeypatch.setattr(teval, "build_grid_plan", rec.grid_plan)
    monkeypatch.setattr(teval, "build_hist_plan", rec.hist_plan)
    return rec, teval.main(argv + ["--device", "cpu"])


def _same(name, got, want, splat):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if not splat or name not in ("img_init", "img_main", "rgb_used"):
        np.testing.assert_array_equal(got, want, err_msg=name)
    elif name == "rgb_used":  # colours in [0, 255]: one 8-bit step
        assert np.abs(got - want).max() <= 1.0, name
    else:  # a splat panorama: each framework rasterizes the cloud itself
        pixels = np.abs(got - want).reshape(-1, 3).max(-1)
        assert (pixels == 0).mean() >= 0.999, name


@pytest.mark.parametrize("arm", list(ARMS))
def test_localize_inputs_match_the_script(jscript, monkeypatch, capsys, arm):
    argv = ARMS[arm]
    want, _ = _record_jax(jscript, monkeypatch, argv)
    jax_out = capsys.readouterr().out
    got, _ = _record_port(monkeypatch, argv)
    port_out = capsys.readouterr().out
    splat = "raycast" not in argv
    rooms = int(argv[argv.index("--rooms") + 1])
    queries = int(argv[argv.index("--queries") + 1])
    assert len(got.calls) == len(want.calls) == rooms * queries
    assert [(k, kw) for k, _, kw in got.builds] == \
        [(k, kw) for k, _, kw in want.builds]
    for (_, g, _), (_, w, _) in zip(got.builds, want.builds):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            _same(f"build arg {i}", a, b, splat)
    for (g_args, g_kw), (w_args, w_kw) in zip(got.calls, want.calls):
        assert g_kw == w_kw
        assert len(g_args) == len(w_args) == len(POSITIONAL)
        for name, a, b in zip(POSITIONAL, g_args, w_args):
            _same(name, a, b, splat)
    # the admission's messages, then one line a query
    lines = [ln for ln in jax_out.splitlines() if not ln.startswith("room ")]
    assert [ln for ln in port_out.splitlines()
            if not ln.startswith("room ")][:-1] == lines[:-1]
    if arm == "compact":
        assert [(k, kw["compact"], kw["tp_is_pid"])
                for k, _, kw in got.builds] == [("grid", True, True)] * 2
    if arm == "no-plans":
        assert got.builds == []


_QUERY = re.compile(r"room (\d+) \((\w+)\) q(\d+): t_err=([\d.]+) m "
                    r"r_err=([\d.]+) deg")


def _queries(out):
    return [m.groups() for m in map(_QUERY.match, out.splitlines()) if m]


def test_main_matches_the_script(jscript, capsys):
    argv = ["--oracle", "raycast", "--rooms", "2", "--queries", "2",
            "--points", "6000", "--height", "48", "--no-slab"]
    want = jscript.main(argv)
    want_q = _queries(capsys.readouterr().out)
    got = teval.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    got_q = _queries(out)
    assert json.loads(out.splitlines()[-1]) == got
    assert list(got) == list(want) + ["device"]
    assert got["device"] == "cpu"
    for k in ("profile", "oracle", "queries", "stanford_accuracy",
              "omniscenes_accuracy", "descent_table", "prune"):
        assert got[k] == want[k], k
    assert got["stanford_accuracy"] == got["omniscenes_accuracy"] == 1.0
    assert {k: v["stanford_acc"] for k, v in got["by_kind"].items()} == \
        {k: v["stanford_acc"] for k, v in want["by_kind"].items()}
    assert len(got_q) == len(want_q) == 4
    for g, w in zip(got_q, want_q):
        assert g[:3] == w[:3]
        assert abs(float(g[3]) - float(w[3])) < T_ERR_BOUND, (g, w)
        # the same success flags under both criteria
        for t_max, r_max in ((0.2, np.rad2deg(0.2)), (0.1, 5.0)):
            assert ((float(g[3]) < t_max) and (float(g[4]) < r_max)) == \
                ((float(w[3]) < t_max) and (float(w[4]) < r_max)), (g, w)


def test_command_line_matches_the_script(jscript):
    """Every flag of the script, with its default and choices, plus
    --device."""
    import argparse

    captured = {}

    class _Stop(Exception):
        pass

    def grab(self, argv=None, namespace=None):
        captured["parser"] = self
        raise _Stop

    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser, "parse_args", grab)
    try:
        with pytest.raises(_Stop):
            jscript.main([])
    finally:
        mp.undo()

    def flags(parser):
        return {a.dest: (a.default, a.choices, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    want = flags(captured["parser"])
    got = flags(teval.build_parser())
    assert got.pop("device") == ("cuda", ("cuda", "cpu"), "_StoreAction")
    assert got == want


@pytest.mark.parametrize("argv,match", [
    (["--realism", "noise"], "--realism needs --oracle raycast"),
    (["--floor-ref"], "--floor-ref needs --oracle raycast"),
    (["--oracle", "raycast", "--seam-gt", "--full-rot"], "--seam-gt needs"),
    (["--match-color"], "--perturb/--match-color need --oracle raycast"),
])
def test_flag_validation(argv, match):
    with pytest.raises(SystemExit, match=match):
        teval.parse_args(argv)


def test_profile_budgets():
    s = teval.parse_args([])
    assert (s.height, s.points, s.num_trans, s.num_intermediate,
            s.init_step) == (512, 60000, 50, 20, 2)
    o = teval.parse_args(["--profile", "omniscenes", "--full-rot"])
    assert (o.height, o.points, o.num_trans, o.num_intermediate,
            o.init_step) == (1024, 240000, 150, 50, 1)
    r = teval.parse_args(["--oracle", "raycast", "--realism", "jpeg"])
    assert r.realism_val == 60


def test_device_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(SMALL + ["--rooms", "1", "--queries", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(SMALL + ["--rooms", "1", "--queries", "1", "--device",
                            "cuda"])
