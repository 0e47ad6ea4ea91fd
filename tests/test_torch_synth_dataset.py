"""The port's dataset generator (``python -m piccolo_tpu_torch.synth_dataset``)
against ``scripts/make_synth_dataset.py``, and its demo (``python -m
piccolo_tpu_torch.demo``) against ``scripts/demo.py``.

  * A tiny tree from each, both datasets drawn from one generator: the same
    files; clouds byte for byte; camera locations bit for bit, rotations
    (Stanford's Euler angles, OmniScenes' R) within 1e-6, f32 rounding:
    each framework computes R from the yaw with its own sin and cos;
    decoded ray-cast panoramas equal pixel for
    pixel, with every realism arm; splat panoramas (rendered by each
    framework, ``atan2``'s last bit: ROADMAP Queue 3) at least 99.9% equal
    in Stanford's PNGs and 99% in OmniScenes' JPEGs, as the writers' own
    tests require.
  * The demo on the CPU at a small size writes its three images, its query
    image the JAX demo's, and localizes.
"""

import filecmp
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from piccolo_tpu_torch import demo as tdemo
from piccolo_tpu_torch.harness.imaging import imread_rgb
from piccolo_tpu_torch.synth_dataset import main as tgen
from piccolo_tpu_torch.testing import write_synth_omniscenes

torch.set_num_threads(1)

TINY = ["--rooms", "1", "--queries", "2", "--points", "3000", "--height",
        "32"]


def _files(root):
    return sorted(os.path.relpath(p, root) for p in
                  glob.glob(os.path.join(root, "**", "*.*"), recursive=True))


@pytest.mark.parametrize("extra", [
    ["--oracle", "raycast"],
    ["--oracle", "raycast", "--realism", "noise"],
    ["--oracle", "raycast", "--realism", "jpeg"],
    ["--oracle", "raycast", "--realism", "blur", "--realism-val", "5"],
    ["--oracle", "raycast", "--realism", "holes"],
    ["--oracle", "raycast", "--realism", "depth-noise"],
    [],
], ids=["raycast", "noise", "jpeg", "blur-5", "holes", "depth-noise",
        "splat"])
def test_tree_matches_the_script(tmp_path, capsys, extra):
    from scripts.make_synth_dataset import main as jgen

    want, got = str(tmp_path / "script"), str(tmp_path / "port")
    jgen(["--root", want] + TINY + extra)
    tgen(["--root", got] + TINY + extra)
    assert capsys.readouterr().out.splitlines() == [
        f"synthetic dataset written to {want}",
        f"synthetic dataset written to {got}"]
    files = _files(want)
    assert files == _files(got)
    assert sum(f.endswith((".png", ".jpg")) for f in files) == 4
    splat = "raycast" not in extra
    for f in files:
        a, b = os.path.join(want, f), os.path.join(got, f)
        if f.endswith((".png", ".jpg")):
            same = (imread_rgb(a) == imread_rgb(b)).all(-1).mean()
            if not splat:
                assert same == 1.0, (f, same)
            else:
                assert same >= (0.999 if f.endswith(".png") else 0.99), \
                    (f, same)
        elif f.endswith(".json"):  # Stanford: location, Euler angles
            with open(a) as fa, open(b) as fb:
                pa, pb = json.load(fa), json.load(fb)
            assert pa["camera_location"] == pb["camera_location"], f
            np.testing.assert_allclose(pa["final_camera_rotation"],
                                       pb["final_camera_rotation"], rtol=0,
                                       atol=1e-6)
        elif "pose" in f:  # OmniScenes: [R | t]
            pa, pb = np.loadtxt(a), np.loadtxt(b)
            np.testing.assert_array_equal(pa[:, 3], pb[:, 3])
            np.testing.assert_allclose(pa[:, :3], pb[:, :3], rtol=0,
                                       atol=1e-6)
        else:  # cloud text
            assert filecmp.cmp(a, b, shallow=False), f


def test_realism_needs_the_raycast_oracle(tmp_path):
    with pytest.raises(SystemExit, match="--realism needs --oracle raycast"):
        tgen(["--root", str(tmp_path), "--realism", "noise"])
    with pytest.raises(ValueError, match="needs oracle='raycast'"):
        write_synth_omniscenes(str(tmp_path), oracle="splat",
                               realism="holes")
    with pytest.raises(ValueError, match="unknown realism arm"):
        write_synth_omniscenes(str(tmp_path), realism="fog")


def test_demo_writes_its_images(tmp_path, monkeypatch, capsys):
    argv = ["--points", "3000", "--height", "64"]
    out = tdemo.main(argv + ["--device", "cpu", "--out",
                             str(tmp_path / "port")])
    assert out["t_err"] < 0.2 and out["r_err"] < 5.0
    shapes = {k: imread_rgb(p).shape for k, p in out["paths"].items()}
    assert shapes == {"query": (32, 64, 3), "estimated": (32, 64, 3),
                      "side_by_side": (64, 64, 3)}
    side = imread_rgb(out["paths"]["side_by_side"])
    np.testing.assert_array_equal(side[:32], imread_rgb(out["paths"]["query"]))
    np.testing.assert_array_equal(side[32:],
                                  imread_rgb(out["paths"]["estimated"]))

    from scripts import demo as jdemo

    monkeypatch.setattr(sys, "argv", ["demo.py", "--out",
                                      str(tmp_path / "jax")] + argv)
    jdemo.main()
    capsys.readouterr()
    q_jax = imread_rgb(str(tmp_path / "jax" / "query.png"))
    q_port = imread_rgb(out["paths"]["query"])
    assert (q_jax == q_port).all(-1).mean() >= 0.999


def test_demo_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdemo.main(["--out", str(tmp_path)])
