"""The port's CLI (``python -m piccolo_tpu_torch.main --device cpu``) against
the JAX package's on a synthetic Stanford tree from
``scripts/make_synth_dataset.py`` (test_e2e's small configuration).

  * Same CSV header, pano order, gt and skipped cells as ``piccolo_tpu.main``,
    and at lr 0.01 the winners within 1e-3 m.  The reference's descent
    amplifies ulp-level differences on this scene (ROADMAP Queue 3): at lr
    0.1, and at lr 0.01 past ~20 iterations.  So the comparison runs 20
    iterations, and at the configuration's lr 0.1 the port's own accuracy
    must be 1.0.
  * The forced compact and q8 slab plans agree with the auto run (the
    gather engine on the CPU) within 1e-3 m.
  * ``write_synth_stanford`` writes the script's tree.
  * Without a card the CLI raises unless asked for the CPU, and the keys
    of later slices raise NotImplementedError.
"""

import csv
import filecmp
import glob
import os

import numpy as np
import pytest
import torch

from piccolo_tpu_torch.harness.imaging import imread_rgb
from piccolo_tpu_torch.main import main as tmain
from piccolo_tpu_torch.testing import write_synth_stanford

torch.set_num_threads(2)

GEN = ["--rooms", "1", "--queries", "2", "--points", "12000", "--height", "128",
       "--datasets", "stanford"]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from scripts.make_synth_dataset import main as gen

    root = str(tmp_path_factory.mktemp("synth_cli"))
    gen(["--root", root] + GEN)
    return root


def _write_cfg(path, root):
    with open(path, "w") as f:
        f.write(f"""
[Default]
dataset = Stanford2D-3D-S
data_root = {root}
sample_rate = 1
out_of_room_quantile = 0.05
num_trans = 12
xy_only = True
yaw_only = True
z_prior = None
num_yaw = 4
criterion = loss_histogram
num_intermediate = 8
num_input = 4
num_split_h = 4
num_split_w = 4
lr = 0.1
num_iter = 60
patience = 5
factor = 0.8
visualize = False
""")
    return path


def _rows(log):
    with open(os.path.join(log, "stanford_results.csv"), newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _winner(row):
    return np.array([float(v) for v in row[5].split()])


def _port(cfg, log, override=None):
    args = ["--config", cfg, "--log", log, "--no-tensorboard", "--device", "cpu"]
    if override:
        args += ["--override", override]
    return tmain(args)


@pytest.fixture(scope="module")
def auto_run(synth_root, tmp_path_factory):
    d = tmp_path_factory.mktemp("auto")
    cfg = _write_cfg(str(d / "cfg.ini"), synth_root)
    log = str(d / "log")
    return cfg, log, _port(cfg, log)


def test_port_cli_matches_jax_cli(synth_root, tmp_path):
    from piccolo_tpu.main import main as jmain

    cfg = _write_cfg(str(tmp_path / "cfg.ini"), synth_root)
    jlog, tlog = str(tmp_path / "jax"), str(tmp_path / "port")
    ov = "lr=0.01,num_iter=20"
    jmain(["--config", cfg, "--log", jlog, "--no-tensorboard",
           "--override", ov])
    _port(cfg, tlog, ov)
    jh, jrows = _rows(jlog)
    th, trows = _rows(tlog)
    assert th == jh
    assert [r[:5] for r in trows] == [r[:5] for r in jrows]  # order, gt, skip
    assert len(trows) == 2 and all(r[4] == "0" for r in trows)
    for tr, jr in zip(trows, jrows):
        assert np.abs(_winner(tr) - _winner(jr)).max() < 1e-3, (tr, jr)


def test_port_cli_artifacts_and_accuracy(auto_run):
    cfg, log, acc = auto_run
    assert acc == 1.0
    assert os.path.exists(os.path.join(log, "config.ini"))
    header, rows = _rows(log)
    assert header[0] == "area_num" and len(rows) == 2
    pngs = sorted(glob.glob(os.path.join(log, "results", "area_1", "*.png")))
    assert [os.path.basename(p) for p in pngs] == sorted(r[1] for r in rows)
    img = imread_rgb(pngs[0])  # gt (64x128) stacked over the render
    assert img.shape == (128, 128, 3)


@pytest.mark.parametrize("layout", ["slab_compact=True", "slab_quant=True"])
def test_forced_slab_layouts_agree_with_auto(auto_run, layout, tmp_path):
    cfg, log, _ = auto_run
    ov = (f"slab_init=True,{layout},slab_background_build=False,"
          "slab_plan_cache=False")
    acc = _port(cfg, str(tmp_path / "log"), ov)
    assert acc == 1.0
    _, rows = _rows(str(tmp_path / "log"))
    _, auto = _rows(log)
    for r, a in zip(rows, auto):
        assert np.abs(_winner(r) - _winner(a)).max() < 1e-3, (r, a)


@pytest.mark.parametrize("oracle", ["splat", "raycast"])
def test_write_synth_stanford_matches_the_script(synth_root, oracle,
                                                 tmp_path):
    if oracle == "splat":
        want = synth_root
    else:
        from scripts.make_synth_dataset import main as gen

        want = str(tmp_path / "script")
        gen(["--root", want, "--oracle", "raycast"] + GEN)
    got = str(tmp_path / "port")
    write_synth_stanford(got, rooms=1, queries=2, points=12000, height=128,
                         seed=7, oracle=oracle)
    files = sorted(os.path.relpath(p, want) for p in
                   glob.glob(os.path.join(want, "**", "*.*"), recursive=True))
    assert files == sorted(os.path.relpath(p, got) for p in glob.glob(
        os.path.join(got, "**", "*.*"), recursive=True))
    for f in files:
        a, b = os.path.join(want, f), os.path.join(got, f)
        if f.endswith(".png"):
            same = (imread_rgb(a) == imread_rgb(b)).all(-1).mean()
            assert same >= 0.999, (f, same)
        else:  # cloud text and pose JSON
            assert filecmp.cmp(a, b, shallow=False), f


def test_cli_without_a_card_raises(auto_run, monkeypatch, tmp_path):
    cfg, _, _ = auto_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain(["--config", cfg, "--log", str(tmp_path), "--no-tensorboard"])


@pytest.mark.parametrize("override,match", [
    ("n_devices=2", "multi-device"),
    ("fused=False", "staged-path"),
    ("sample_rate_for_init=2", "staged-path"),
    ("descent_prune_iter=10", "prune and multires"),
    ("descent_multires_iter=10", "prune and multires"),
    ("profile_dir=/nonexistent", "profiling"),
    ("exec_cache_dir=/nonexistent", "serving"),
    ("dataset=OmniScenes", "JPEG"),
])
def test_unported_keys_raise(auto_run, override, match, tmp_path):
    cfg, _, _ = auto_run
    with pytest.raises(NotImplementedError, match=match):
        _port(cfg, str(tmp_path / "log"), override)
