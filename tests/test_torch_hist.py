"""The port's stage-2 histogram trim against the JAX package.

  * Z-buffer keys from identical projected pixels and distances: bit-exact.
  * Block histograms (plain version) vs the JAX kernel in Pallas interpret
    mode, ragged N included: bit-exact (integer counts).
  * Scores from JAX-built winner-bin planes carried across: atol 1e-6
    (f32 sums over 512 bins in another order).
  * Scores from each framework's own splat: atol 1e-3 with >= 99.9% of the
    pixel keys equal (atan2 ulps can move a point across a pixel edge).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu.init import refine as jrefine
from piccolo_tpu.kernels.histogram_mxu import block_histogram_pallas
from piccolo_tpu.loss import Pose as JPose, transform_cloud as jtransform
from piccolo_tpu.ops import histogram as jhist
from piccolo_tpu.ops import pano as jpano
from piccolo_tpu.ops.projection import spherical_project as jproject
from piccolo_tpu.testing import make_room, render_at as jrender_at
from piccolo_tpu_torch.convert import hist_plan_from_numpy
from piccolo_tpu_torch.init import refine as trefine
from piccolo_tpu_torch.kernels.block_histogram import (
    block_histogram,
    block_histogram_plain,
)
from piccolo_tpu_torch.loss import Pose as TPose, transform_cloud as ttransform
from piccolo_tpu_torch.ops import histogram as thist
from piccolo_tpu_torch.ops import pano as tpano
from piccolo_tpu_torch.testing import render_at as trender_at

torch.set_num_threads(2)

H, W = 32, 64


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    xyz, rgb = make_room(rng, n_per_wall=300, texture="checker")
    rgb[::11] = 0.0  # pure-black points bin to the background sentinel
    mask = np.ones(xyz.shape[0], bool)
    mask[::13] = False
    img = np.asarray(jrender_at(xyz, rgb, np.array([0.2, 0.1, 0.0], np.float32),
                                np.array([1.0, 0.0, 0.0], np.float32), (H, W)))
    trans = rng.uniform(-1.0, 1.0, (6, 3)).astype(np.float32)
    ypr = np.stack([rng.uniform(0, 6.28, 6), np.zeros(6), np.zeros(6)],
                   1).astype(np.float32)
    return dict(xyz=xyz, rgb=rgb, mask=mask, img=img, trans=trans, ypr=ypr)


def _jax_cam(s, i):
    p = JPose(t=jnp.asarray(s["trans"][i]), yaw=jnp.asarray(s["ypr"][i, 0]),
              pitch=jnp.asarray(s["ypr"][i, 1]), roll=jnp.asarray(s["ypr"][i, 2]))
    return jtransform(p, jnp.asarray(s["xyz"]))


def test_attr_min_keys_bit_exact_from_identical_pixels(scene):
    s = scene
    attr = np.random.default_rng(6).integers(0, 513, s["xyz"].shape[0]).astype(np.int32)
    for i in range(3):
        cam = _jax_cam(s, i)
        want = np.asarray(jpano.attr_min_keys(cam, jnp.asarray(attr), 10, (H, W),
                                              jnp.asarray(s["mask"])))
        # the JAX package's projection lines, fed to the port's key half
        dist = jnp.sqrt(jnp.sum(cam * cam, axis=-1))
        coords = jproject(cam)
        col0 = jnp.floor((coords[..., 0] + 1.0) / 2.0 * (W - 1)).astype(jnp.int32)
        row0 = jnp.floor((coords[..., 1] + 1.0) / 2.0 * (H - 1)).astype(jnp.int32)
        got = tpano.attr_min_keys_from_pixels(
            torch.tensor(np.asarray(dist))[None],
            torch.tensor(np.asarray(row0)).long()[None],
            torch.tensor(np.asarray(col0)).long()[None],
            torch.tensor(attr), 10, (H, W), torch.tensor(s["mask"]))[0]
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tpano.attr_min_decode(got, 10).numpy(),
            np.asarray(jpano.attr_min_decode(jnp.asarray(want), 10)))


def test_render_at_matches(scene):
    s = scene
    t, ypr = np.array([0.2, 0.1, 0.0], np.float32), np.array([1.0, 0.0, 0.0], np.float32)
    got = trender_at(s["xyz"], s["rgb"], t, ypr, (H, W), device="cpu").numpy()
    want = s["img"]
    assert np.all(got == want, axis=-1).mean() >= 0.99


@pytest.mark.parametrize("B,N", [(6, 3000), (4, 4096), (3, 777)])
def test_block_histogram_plain_matches_pallas(B, N):
    rng = np.random.default_rng(B * N)
    ids = rng.integers(-3, 530, (B, N)).astype(np.int32)
    mask = (rng.random((B, N)) < 0.7).astype(np.float32)
    want = np.asarray(block_histogram_pallas(jnp.asarray(ids), jnp.asarray(mask), 512))
    got = block_histogram_plain(torch.tensor(ids), torch.tensor(mask), 512)
    np.testing.assert_array_equal(got.numpy(), want)
    got_w = block_histogram(torch.tensor(ids), torch.tensor(mask), 512)
    np.testing.assert_array_equal(got_w.numpy(), want)
    assert block_histogram.launches == 0  # CPU: plain version


def test_histogram_ops_exact(scene):
    s = scene
    img255 = s["img"] * 255.0
    mask = np.sum(img255 == 0.0, -1) != 3
    np.testing.assert_array_equal(
        thist.bin_ids(torch.tensor(img255)).numpy(),
        np.asarray(jhist.bin_ids(jnp.asarray(img255))))
    h_t, c_t = thist.block_histograms(torch.tensor(img255), torch.tensor(mask),
                                      (8, 8, 8), 4, 4)
    h_j, c_j = jhist.block_histograms(jnp.asarray(img255), jnp.asarray(mask),
                                      (8, 8, 8), 4, 4)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    m_t = thist.masked_histogram(torch.tensor(img255), torch.tensor(mask))
    m_j = jhist.masked_histogram(jnp.asarray(img255), jnp.asarray(mask))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        thist.histogram_intersection(h_t, h_t.flip(0)).numpy(),
        np.asarray(jhist.histogram_intersection(h_j, h_j[::-1])), rtol=1e-6)


def test_hist_scores_from_carried_planes(scene):
    s = scene
    jplan = jrefine.build_hist_plan(
        jnp.asarray(s["xyz"]), jnp.asarray(s["rgb"]), jnp.asarray(s["trans"]),
        jnp.asarray(s["ypr"][:2]), H, W, point_mask=jnp.asarray(s["mask"]))
    plan = hist_plan_from_numpy(np.asarray(jplan.planes), jplan.n_pairs, H, W,
                                device="cpu")
    sel = np.array([3, 0, 7, 7, 11, 5, 2, 9])
    want = np.asarray(jrefine.hist_scores_from_planes(
        jnp.asarray(s["img"]), jplan.planes[sel], 4, 4, 4))
    got = trefine.hist_scores_from_planes(torch.tensor(s["img"]),
                                          plan.planes[sel], 4, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the port's own planes agree with the JAX ones on almost every pixel
    tplan = trefine.build_hist_plan(s["xyz"], s["rgb"], s["trans"], s["ypr"][:2],
                                    H, W, point_mask=s["mask"], device="cpu")
    assert (tplan.planes.numpy() == np.asarray(jplan.planes)).mean() >= 0.999


def test_hist_scores_core_own_splats(scene):
    s = scene
    want = np.asarray(jrefine.hist_scores_core(
        jnp.asarray(s["img"]), jnp.asarray(s["xyz"]), jnp.asarray(s["rgb"]),
        jnp.asarray(s["trans"]), jnp.asarray(s["ypr"]), jnp.asarray(s["mask"]),
        4, 4, 2))
    got = trefine.hist_scores_core(
        torch.tensor(s["img"]), torch.tensor(s["xyz"]), torch.tensor(s["rgb"]),
        torch.tensor(s["trans"]), torch.tensor(s["ypr"]), torch.tensor(s["mask"]),
        4, 4, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    bins = jrefine._point_bins(jnp.asarray(s["rgb"]), 512)
    tbins = trefine._point_bins(torch.tensor(s["rgb"]), 512)
    np.testing.assert_array_equal(tbins.numpy(), np.asarray(bins))
    same = []
    for i in range(s["trans"].shape[0]):
        jk = np.asarray(jpano.attr_min_keys(_jax_cam(s, i), bins, 10, (H, W),
                                            jnp.asarray(s["mask"])))
        p = TPose(torch.tensor(s["trans"][i]), *torch.tensor(s["ypr"][i]))
        tk = tpano.attr_min_keys(ttransform(p, torch.tensor(s["xyz"])), tbins,
                                 10, (H, W), torch.tensor(s["mask"]))
        same.append((tk.numpy() == jk).mean())
    assert np.mean(same) >= 0.999


def test_trims_select_like_jax(scene):
    s = scene
    args_t = [torch.tensor(s[k]) for k in ("img", "xyz", "rgb", "trans", "ypr")]
    args_j = [jnp.asarray(s[k]) for k in ("img", "xyz", "rgb", "trans", "ypr")]
    t_t, r_t = trefine.trim_by_hist(*args_t, 3, 4, 4)
    t_j, r_j = jrefine.trim_by_hist(*args_j, 3, 4, 4)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    t_t, r_t = trefine.trim_by_loss(*args_t, 5, torch.tensor(s["mask"]))
    t_j, r_j = jrefine.trim_by_loss(*args_j, 5, jnp.asarray(s["mask"]))
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
