"""The port's host modules against the JAX package: config, colour, the
cloud loader and GT poses, imaging (PNG codec and resize, held against
cv2), the slab plan disk cache (both directions) and the masked histogram
against ``histogram_pallas`` (interpret mode)."""

import glob
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu import color as jcolor
from piccolo_tpu import config as jconfig
from piccolo_tpu.data import loader as jloader
from piccolo_tpu.data import stanford as jstanford
from piccolo_tpu.kernels import histogram_pallas
from piccolo_tpu.kernels import plan_cache as jpc
from piccolo_tpu.kernels import slab_sampling as jslab
from piccolo_tpu.ops.histogram import masked_histogram as jmasked_histogram
from piccolo_tpu_torch import color, config
from piccolo_tpu_torch.data import loader, stanford
from piccolo_tpu_torch.harness import imaging
from piccolo_tpu_torch.kernels import plan_cache as pc
from piccolo_tpu_torch.kernels import slab_sampling as tslab
from piccolo_tpu_torch.kernels.histogram import (
    masked_histogram_counts,
    masked_histogram_counts_plain,
)
from piccolo_tpu_torch.ops.histogram import masked_histogram
from piccolo_tpu_torch.testing import write_synth_stanford

torch.set_num_threads(2)
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.mark.parametrize("name", sorted(os.listdir(CONFIGS)))
def test_config_parses_like_jax(name, tmp_path):
    path = os.path.join(CONFIGS, name)
    ov = "num_iter=50,lr=0.2,area=1,2,slab_init=True"
    got = config.apply_overrides(config.parse_ini(path), ov)
    want = jconfig.apply_overrides(jconfig.parse_ini(path), ov)
    assert got._asdict() == want._asdict()
    a = config.save_config(got, str(tmp_path / "a"))
    b = jconfig.save_config(want, str(tmp_path / "b"))
    assert open(a).read() == open(b).read()
    assert config.cfg_get(got, "missing", 7) == 7


@pytest.fixture(scope="module")
def colours():
    rng = np.random.default_rng(4)
    img = (rng.integers(0, 256, (48, 96, 3)) / 255.0).astype(np.float32)
    img[:5] = 0.0  # black rows are left untouched
    rgb = (rng.integers(0, 256, (2000, 3)) / 255.0).astype(np.float32)
    return img, rgb


@pytest.mark.parametrize("num_bins", [256, 64])
def test_color_mod_bit_exact(colours, num_bins):
    img, rgb = colours
    got_img, got_rgb = color.color_mod(img, rgb, num_bins)
    want_img, want_rgb = jcolor.color_mod(img, rgb, num_bins)
    assert jcolor._HAS_CV2  # the reference side converts with cv2 here
    np.testing.assert_array_equal(got_img, want_img)
    np.testing.assert_array_equal(got_rgb, want_rgb)


def test_color_match_bit_exact(colours):
    img, rgb = colours
    np.testing.assert_array_equal(color.color_match(img, rgb),
                                  jcolor.color_match(img, rgb))


def test_ycrcb_round_trip_equals_cv2():
    rng = np.random.default_rng(9)
    px = rng.integers(0, 256, (4096, 3), dtype=np.uint8)
    ycc = cv2.cvtColor(px[None], cv2.COLOR_RGB2YCR_CB)[0]
    np.testing.assert_array_equal(color.rgb_to_ycrcb(px), ycc)
    np.testing.assert_array_equal(
        color.ycrcb_to_rgb(px), cv2.cvtColor(px[None], cv2.COLOR_YCR_CB2RGB)[0])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_io"))
    write_synth_stanford(root, rooms=1, queries=2, points=3000, height=32,
                         seed=3, oracle="raycast")
    return root


def test_cloud_loader_and_gt_match_jax(tree):
    pcd = glob.glob(os.path.join(tree, "stanford", "pcd_not_aligned", "*",
                                 "*.txt"))[0]
    for rate in (1, 3):
        np.random.seed(5)
        xyz, rgb = stanford.read_stanford(pcd, rate)
        np.random.seed(5)
        jxyz, jrgb = jstanford.read_stanford(pcd, rate)
        np.testing.assert_array_equal(xyz.astype(np.float32),
                                      jxyz.astype(np.float32))
        np.testing.assert_array_equal(rgb.astype(np.float32),
                                      jrgb.astype(np.float32))
    np.random.seed(1)
    a = loader.subsample(xyz, rgb, 2.0)
    np.random.seed(1)
    b = jloader.subsample(xyz, rgb, 2.0)
    np.testing.assert_array_equal(a[0], b[0])
    for pano in glob.glob(os.path.join(tree, "stanford", "pano", "*", "*.png")):
        name = os.path.basename(pano)
        for g, w in zip(stanford.obtain_gt_stanford(tree, 1, name),
                        jstanford.obtain_gt_stanford(tree, 1, name)):
            np.testing.assert_array_equal(g, w)


def _images():
    rng = np.random.default_rng(2)
    noise = rng.integers(0, 256, (40, 72, 3), dtype=np.uint8)
    smooth = cv2.GaussianBlur(noise, (7, 7), 2)
    ramp = np.broadcast_to(np.arange(72, dtype=np.uint8)[None, :, None] * 3,
                           (40, 72, 3)).copy()
    return {"noise": noise, "smooth": smooth, "ramp": ramp}


@pytest.mark.parametrize("kind", ["noise", "smooth", "ramp"])
def test_png_codec_against_cv2(kind, tmp_path):
    img = _images()[kind]
    src = str(tmp_path / "cv2.png")
    cv2.imwrite(src, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    want = cv2.cvtColor(cv2.imread(src), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(imaging.imread_rgb(src), want)
    # grey and RGBA files decode as cv2's IMREAD_COLOR does
    for conv, back in ((cv2.COLOR_RGB2GRAY, cv2.COLOR_GRAY2RGB),
                       (cv2.COLOR_RGB2BGRA, None)):
        p = str(tmp_path / f"c{conv}.png")
        cv2.imwrite(p, cv2.cvtColor(img, conv))
        np.testing.assert_array_equal(
            imaging.imread_rgb(p), cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB))
    dst = str(tmp_path / "port.png")
    imaging.imwrite_rgb(dst, img)
    np.testing.assert_array_equal(
        cv2.cvtColor(cv2.imread(dst), cv2.COLOR_BGR2RGB), img)


def test_png_decode_refuses_what_it_cannot_read(tmp_path):
    img = _images()["smooth"]
    p16 = str(tmp_path / "deep.png")
    cv2.imwrite(p16, img.astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="bit depth 16"):
        imaging.imread_rgb(p16)
    # JPEG has its own decoder now (test_torch_jpeg.py); other formats raise
    pb = str(tmp_path / "a.bmp")
    cv2.imwrite(pb, img)
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        imaging.imread_rgb(pb)
    with pytest.raises(ValueError, match="only PNG and JPEG"):
        imaging.imwrite_rgb(str(tmp_path / "x.bmp"), img)


@pytest.mark.parametrize("factor", [1, 2, 3, 4, 1.5])
def test_resize_equals_cv2(factor):
    rng = np.random.default_rng(6)
    img = cv2.GaussianBlur(rng.integers(0, 256, (96, 192, 3), dtype=np.uint8),
                           (5, 5), 1.5)
    img[::7] = rng.integers(0, 256, img[::7].shape, dtype=np.uint8)
    size = (int(192 / factor), int(96 / factor))
    np.testing.assert_array_equal(imaging.resize(img, size),
                                  cv2.resize(img, size))


@pytest.fixture(scope="module")
def plan_room():
    rng = np.random.default_rng(8)
    xyz = rng.uniform(-2, 2, (1024, 3)).astype(np.float32)
    rgb = (rng.integers(0, 256, (1024, 3)) / 255.0).astype(np.float32)
    mask = np.arange(1024) < 1000
    trans = rng.uniform(-0.5, 0.5, (3, 3)).astype(np.float32)
    rot = np.stack([np.linspace(0, 6, 8), np.zeros(8), np.zeros(8)],
                   1).astype(np.float32)
    return xyz, rgb, mask, trans, rot


def _assert_plans_equal(a, b):
    for k in ("n_pairs", "height", "width", "wrap", "window", "block",
              "compact", "tp_is_pid", "quant"):
        assert getattr(a, k) == getattr(b, k), k
    for xs, ys in ((a.fields, b.fields), (a.windows, b.windows),
                   (a.tps, b.tps)):
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("layout", [dict(), dict(compact=True, tp_is_pid=True),
                                    dict(compact=True, quant=True)])
def test_plan_cache_crosses_packages(plan_room, layout, tmp_path):
    xyz, rgb, mask, trans, rot = plan_room
    kw = dict(compact=layout.get("compact", False),
              tp_is_pid=layout.get("tp_is_pid", False),
              quant=layout.get("quant", False))
    key = pc.plan_key(torch.tensor(xyz), torch.tensor(rgb), torch.tensor(mask),
                      torch.tensor(trans), torch.tensor(rot), 24, 48, **kw)
    assert key == jpc.plan_key(jnp.asarray(xyz), jnp.asarray(rgb),
                               jnp.asarray(mask), jnp.asarray(trans),
                               jnp.asarray(rot), 24, 48, **kw)
    jplan = jslab.build_grid_plan(*(jnp.asarray(a) for a in plan_room),
                                  24, 48, **layout)
    tplan = tslab.build_grid_plan(*plan_room, 24, 48, device="cpu", **layout)
    jdir, tdir = str(tmp_path / "from_jax"), str(tmp_path / "from_port")
    jpc.save_plan(jdir, key, jplan)
    pc.save_plan(tdir, key, tplan)
    _assert_plans_equal(pc.load_plan(jdir, key, device="cpu"), jplan)
    _assert_plans_equal(jpc.load_plan(tdir, key), tplan)
    assert pc.load_plan(jdir, "missing", device="cpu") is None
    assert pc.evict_lru(jdir, 0) == 1


@pytest.mark.parametrize("n", [3001, 4096])
def test_masked_histogram_plain_matches_pallas(n):
    rng = np.random.default_rng(n)
    ids = rng.integers(-3, 530, n).astype(np.int32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    want = np.asarray(histogram_pallas(jnp.asarray(ids), jnp.asarray(mask), 512))
    got = masked_histogram_counts(torch.tensor(ids), torch.tensor(mask), 512)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        masked_histogram_counts_plain(torch.tensor(ids), torch.tensor(mask))
        .numpy(), want)
    assert masked_histogram_counts.launches == 0  # CPU: the plain version
    img = rng.integers(0, 256, (n, 3)).astype(np.float32)
    m = rng.random(n) < 0.5
    for norm in (False, True):
        want = np.asarray(jmasked_histogram(jnp.asarray(img), jnp.asarray(m),
                                            normalize=norm, use_pallas=True))
        got = masked_histogram(torch.tensor(img), torch.tensor(m),
                               normalize=norm, use_kernel=True).numpy()
        np.testing.assert_array_equal(got, want)
