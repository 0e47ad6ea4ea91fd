"""The port's own copies of the JAX package's host helpers, and its staged
descent, against the JAX package.

The numpy copies (room factory, candidate grids, order quantiles, cloud
padding, the 24-bit colour packing) must return identical arrays from the
same inputs.  ``solver.descend`` (the default branch: every start for the
full budget) agrees with JAX's on poses within 1e-4 and on the final
learning rates exactly, at lr 0.01 where the descent is well conditioned.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu import testing as jtesting
from piccolo_tpu.harness import localize as jharness
from piccolo_tpu.init import candidates as jcand
from piccolo_tpu.kernels import slab_sampling as jslab
from piccolo_tpu.ops import quantile as jquant
from piccolo_tpu.solver import descend as jdescend
from piccolo_tpu_torch import testing as ttesting
from piccolo_tpu_torch.harness import localize as tharness
from piccolo_tpu_torch.init import candidates as tcand
from piccolo_tpu_torch.kernels import slab_sampling as tslab
from piccolo_tpu_torch.ops import quantile as tquant
from piccolo_tpu_torch.solver import descend

torch.set_num_threads(2)


@pytest.mark.parametrize("texture", ["gradient", "checker"])
def test_room_and_poses_match_jax(texture):
    xyz_t, rgb_t = ttesting.make_room(np.random.default_rng(4), 300,
                                      texture=texture)
    xyz_j, rgb_j = jtesting.make_room(np.random.default_rng(4), 300,
                                      texture=texture)
    np.testing.assert_array_equal(xyz_t, xyz_j)
    np.testing.assert_array_equal(rgb_t, rgb_j)
    for yaw_only in (True, False):
        t_t, y_t = ttesting.random_pose_inside(np.random.default_rng(9),
                                               yaw_only=yaw_only)
        t_j, y_j = jtesting.random_pose_inside(np.random.default_rng(9),
                                               yaw_only=yaw_only)
        np.testing.assert_array_equal(t_t, t_j)
        np.testing.assert_array_equal(y_t, y_j)


@pytest.mark.parametrize("kw", [
    dict(xy_only=True, yaw_only=True, num_yaw=8, num_trans=50, z_prior=None),
    dict(xy_only=False, yaw_only=False, num_yaw=4, num_pitch=2, num_roll=2,
         num_trans=30),
])
def test_candidate_grids_match_jax(kw):
    xyz, _ = jtesting.make_room(np.random.default_rng(2), 500)
    d_t, d_j = tcand.default_init_dict(**kw), jcand.default_init_dict(**kw)
    assert d_t == d_j
    np.testing.assert_array_equal(tcand.generate_trans_points(xyz, d_t),
                                  jcand.generate_trans_points(xyz, d_j))
    np.testing.assert_array_equal(tcand.generate_rot_points(d_t),
                                  jcand.generate_rot_points(d_j))


def test_cloud_helpers_match_jax():
    rng = np.random.default_rng(8)
    for n in (1, 4096, 4097, 6144, 6145, 60000):
        assert tharness._bucket(n) == jharness._bucket(n)
    xyz = rng.normal(size=(5000, 3)).astype(np.float32)
    rgb = rng.random((5000, 3)).astype(np.float32)
    for a, b in zip(tharness._pad_cloud(xyz, rgb, "cpu"),
                    jharness._pad_cloud(xyz, rgb)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tharness._order_bounds(xyz, 0.05),
                    jharness._order_bounds(xyz, 0.05)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tquant.order_quantile(xyz[:, 0], 0.1),
                    jquant.order_quantile(xyz[:, 0], 0.1)):
        assert a == b
    for a, b in zip(tquant.cloud_bounds(xyz), jquant.cloud_bounds(xyz)):
        np.testing.assert_array_equal(a, np.asarray(b))
    rgb[:7] = [[0, 0, 0], [1, 1, 1], [-0.5, 2, 0.5], [0.5, 0.5, 0.5],
               [1 / 255, 2 / 255, 254.5 / 255], [0.25, 0.75, 0.1], [1, 0, 1]]
    np.testing.assert_array_equal(
        tslab.pack_rgb24(torch.tensor(rgb)).numpy(),
        np.asarray(jslab.pack_rgb24(jnp.asarray(rgb))))


def test_staged_descend_matches_jax():
    rng = np.random.default_rng(21)
    xyz, rgb = jtesting.make_room(rng, n_per_wall=300, texture="checker")
    img = np.asarray(jtesting.render_at(
        xyz, rgb, np.array([0.4, -0.3, 0.1], np.float32),
        np.array([2.0, 0.0, 0.0], np.float32), (32, 64)))
    lo, hi = tharness._order_bounds(xyz, 0.05)
    t0 = np.array([[0.3, -0.2, 0.0], [0.5, -0.4, 0.2], [0.0, 0.0, 0.0]],
                  np.float32)
    y0 = np.array([[1.9, 0.0, 0.0], [2.1, 0.05, 0.0], [1.5, 0.0, 0.1]],
                  np.float32)
    kw = dict(num_iter=12, lr=0.01, patience=2, factor=0.5)
    got = descend(img, xyz, rgb, t0, y0, lo, hi, device="cpu", **kw)
    want = jdescend(*(jnp.asarray(a) for a in (img, xyz, rgb, t0, y0, lo, hi)),
                    **kw)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_allclose(got.ypr.numpy(), np.asarray(want.ypr), atol=1e-4)
    np.testing.assert_allclose(got.rot.numpy(), np.asarray(want.rot), atol=1e-4)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.lr.numpy(), np.asarray(want.lr))
