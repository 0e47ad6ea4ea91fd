"""The port's OmniScenes CLI (``python -m piccolo_tpu_torch.main --device
cpu``) against the JAX package's, on a ray-cast tree from
``scripts/make_synth_dataset.py --datasets omniscenes`` (1 room, 2 frames
of a handheld walk, 2048x1024 JPEG panoramas, so the harness's 2048x1024
resize is the identity and every later resize a downscale, where the
port's resize equals cv2's bit for bit).

  * Fused and ``fused = False``: the same CSV header, pano names, gt and
    skipped cells, and at lr 0.01 with 20 iterations the winners within
    1e-3 m (the reference's descent amplifies ulp-level differences past
    that, ROADMAP Queue 3).
  * The OmniScenes image prep (ablations, match_color / sharpen_color,
    init halving, resizes) equals the JAX package's bit for bit.
  * ``write_synth_omniscenes`` writes the script's clouds and poses.
  * ``save_starting_point`` writes one image per start.
"""

import csv
import filecmp
import glob
import os

import numpy as np
import pytest
import torch

from piccolo_tpu_torch.config import apply_overrides, parse_ini
from piccolo_tpu_torch.data import omniscenes as tomni
from piccolo_tpu_torch.harness import localize as hl
from piccolo_tpu_torch.harness.imaging import imread_rgb
from piccolo_tpu_torch.main import main as tmain
from piccolo_tpu_torch.testing import write_synth_omniscenes

torch.set_num_threads(2)

GEN = ["--rooms", "1", "--queries", "2", "--points", "12000", "--height",
       "1024", "--datasets", "omniscenes", "--oracle", "raycast"]
SMALL = ["--rooms", "1", "--queries", "3", "--points", "3000", "--height",
         "32", "--datasets", "omniscenes"]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from scripts.make_synth_dataset import main as gen

    root = str(tmp_path_factory.mktemp("synth_omni"))
    gen(["--root", root] + GEN)
    return root


def _write_cfg(path, root):
    """configs/omniscenes.ini at a small scale: a 256x128 init and main
    image (init_downsample 16, halved to 8 by the harness)."""
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
""")
    return path


def _rows(log):
    with open(os.path.join(log, "omniscenes_results.csv"), newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _winner(row):
    return np.array([float(v) for v in row[4].split()])


def _port(cfg, log, override=None):
    args = ["--config", cfg, "--log", log, "--no-tensorboard", "--device",
            "cpu"]
    if override:
        args += ["--override", override]
    return tmain(args)


@pytest.fixture(scope="module")
def port_runs(synth_root, tmp_path_factory):
    d = tmp_path_factory.mktemp("omni_port")
    cfg = _write_cfg(str(d / "cfg.ini"), synth_root)
    out = {}
    for mode, ov in (("fused", None), ("staged", "fused=False")):
        log = str(d / mode)
        out[mode] = (log, _port(cfg, log, ov))
    return cfg, out


@pytest.mark.parametrize("mode,override", [("fused", None),
                                           ("staged", "fused=False")])
def test_port_cli_matches_jax_cli(synth_root, port_runs, mode, override,
                                  tmp_path):
    from piccolo_tpu.main import main as jmain

    cfg, runs = port_runs
    jlog = str(tmp_path / "jax")
    args = ["--config", cfg, "--log", jlog, "--no-tensorboard"]
    jmain(args + (["--override", override] if override else []))
    jh, jrows = _rows(jlog)
    th, trows = _rows(runs[mode][0])
    assert th == jh
    assert [r[:4] for r in trows] == [r[:4] for r in jrows]  # names, gt, skip
    assert len(trows) == 2 and all(r[3] == "0" for r in trows)
    for tr, jr in zip(trows, jrows):
        assert np.abs(_winner(tr) - _winner(jr)).max() < 1e-3, (tr, jr)


def test_fused_and_staged_agree(port_runs):
    """The staged path selects the fused path's starts, so both descend to
    the same winners; on the ray-cast frames both localize."""
    _, runs = port_runs
    (_, fused), (_, staged) = _rows(runs["fused"][0]), _rows(runs["staged"][0])
    for a, b in zip(fused, staged):
        assert np.abs(_winner(a) - _winner(b)).max() < 1e-6, (a, b)
    assert runs["fused"][1] == runs["staged"][1] == 1.0


def test_save_starting_point_writes_one_image_a_start(port_runs, tmp_path):
    cfg, _ = port_runs
    log = str(tmp_path / "log")
    _port(cfg, log, "save_starting_point=True,num_iter=2,room_name=pyebang,"
                    "scene_number=1")
    files = sorted(glob.glob(os.path.join(log, "starting_points", "*", "*.png")))
    names = [os.path.relpath(p, os.path.join(log, "starting_points"))
             for p in files]
    video = "handheld_pyebang_1_scene_1"
    assert names == [f"{video}/{q:06d}_{i}.png" for q in range(2)
                     for i in range(4)]
    img = imread_rgb(files[0])  # 1024x2048 stacked over the half render
    assert img.shape == (1024, 1024, 3)


def test_filters_select_no_pano(port_runs, tmp_path):
    cfg, _ = port_runs
    for ov in ("room_name=nowhere", "scene_number=9", "split_name=other"):
        acc = _port(cfg, str(tmp_path / ov.split("=")[0]), ov)
        assert acc == 0.0


@pytest.mark.parametrize("oracle", ["splat", "raycast"])
def test_write_synth_omniscenes_matches_the_script(oracle, tmp_path):
    from scripts.make_synth_dataset import main as gen

    want = str(tmp_path / "script")
    gen(["--root", want, "--oracle", oracle] + SMALL)
    got = str(tmp_path / "port")
    write_synth_omniscenes(got, rooms=1, queries=3, points=3000, height=32,
                           seed=7, oracle=oracle)
    files = sorted(os.path.relpath(p, want) for p in
                   glob.glob(os.path.join(want, "**", "*.*"), recursive=True))
    assert files == sorted(os.path.relpath(p, got) for p in glob.glob(
        os.path.join(got, "**", "*.*"), recursive=True))
    assert sum(f.endswith(".jpg") for f in files) == 3
    for f in files:
        a, b = os.path.join(want, f), os.path.join(got, f)
        if f.endswith(".jpg"):
            same = (imread_rgb(a) == imread_rgb(b)).all(-1).mean()
            assert same >= 0.99, (f, same)
        elif "pose" in f:  # [R|t]: t exact, R within f32 rounding
            pa, pb = np.loadtxt(a), np.loadtxt(b)
            np.testing.assert_array_equal(pa[:, 3], pb[:, 3])
            np.testing.assert_allclose(pa[:, :3], pb[:, :3], rtol=0,
                                       atol=1e-6)
        else:  # cloud text
            assert filecmp.cmp(a, b, shallow=False), f


def test_data_paths_and_gt_match_jax(synth_root):
    from piccolo_tpu.data import omniscenes as jomni

    assert tomni.omniscenes_pcd_path("r", "a", "1") == \
        jomni.omniscenes_pcd_path("r", "a", "1")
    assert tomni.omniscenes_pano_glob("r", "s") == jomni.omniscenes_pano_glob(
        "r", "s")
    panos = sorted(glob.glob(tomni.omniscenes_pano_glob(synth_root)))
    assert len(panos) == 2
    for p in panos:
        for a, b in zip(tomni.obtain_gt_omniscenes(p),
                        jomni.obtain_gt_omniscenes(p)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("override", [
    "", "sharpen_color=True,match_color=False", "synth_const=3",
    "synth_gamma=0.7", "synth_wb=True,synth_r=1.3,synth_g=0.9,synth_b=1.1",
])
def test_image_prep_matches_jax(synth_root, override, tmp_path):
    """The whole OmniScenes prep from the decoded native frame, on the
    port and in the JAX package, from the same pixels."""
    from piccolo_tpu import config as jconfig
    from piccolo_tpu.harness import localize as jhl

    cfg_path = _write_cfg(str(tmp_path / "cfg.ini"), synth_root)
    ov = override or None
    cfg = apply_overrides(parse_ini(cfg_path), ov)
    jcfg = jconfig.apply_overrides(jconfig.parse_ini(cfg_path), ov)
    pano = sorted(glob.glob(tomni.omniscenes_pano_glob(synth_root)))[0]
    raw = imread_rgb(pano)
    pcd = glob.glob(os.path.join(synth_root, "omniscenes", "pcd", "*.txt"))[0]
    xyz, rgb = (a.astype(np.float32) for a in tomni.read_omniscenes(pcd))
    xyz_d, rgb_d, mask_d = hl._pad_cloud(xyz, rgb, "cpu")
    room = dict(rgb=rgb_d, rgb_np=rgb, mask=mask_d, device=torch.device("cpu"))
    jroom = dict(rgb=rgb_d.numpy(), rgb_np=rgb, mask=mask_d.numpy())
    got = hl.prepare_omniscenes_images(cfg, raw, room)
    want = jhl.prepare_omniscenes_images(jcfg, raw, jroom)
    for a, b in zip(got[:3], want[:3]):  # orig, init and main images
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got[1].shape == (128, 256, 3) and got[2].shape == (128, 256, 3)
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))
