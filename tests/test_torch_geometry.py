"""The port's geometry, sampling and loss against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances:
  * trig (rot_x/y/z): 1 ulp — torch's and XLA's CPU sin/cos differ in the
    last bit;
  * rot_from_ypr: 2^-23 absolute, one ulp at the unit scale of the
    factors — XLA's CPU dot accumulates the 3-term products as an FMA
    chain, the port as separate f32 multiply-adds (no FMA on any device),
    and one-ulp trig differences cancel into small entries;
  * spherical_project: 2^-22 absolute, one ulp at the magnitude 2 the
    coordinates are computed at (atan2 differs in the last bit);
  * no transcendental function: bit-exact;
  * loss values and pose gradients: rtol 1e-5, atol 1e-6 (atan2 ulps and
    the order of the sum over points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu import loss as jloss
from piccolo_tpu.ops import projection as jproj
from piccolo_tpu.ops import rotation as jrot
from piccolo_tpu.ops import sampling as jsamp
from piccolo_tpu.testing import make_room, render_at
from piccolo_tpu_torch import loss as tloss
from piccolo_tpu_torch.ops import projection as tproj
from piccolo_tpu_torch.ops import rotation as trot
from piccolo_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["rot_x", "rot_y", "rot_z"])
def test_axis_rotations_within_one_ulp(name):
    a = np.random.default_rng(0).uniform(-4, 4, 2000).astype(np.float32)
    want = np.asarray(getattr(jrot, name)(jnp.asarray(a)))
    got = getattr(trot, name)(torch.tensor(a)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_rot_from_ypr():
    ypr = np.random.default_rng(1).uniform(-4, 4, (2000, 3)).astype(np.float32)
    want = np.asarray(jrot.rot_from_ypr(jnp.asarray(ypr)))
    got = trot.rot_from_ypr(torch.tensor(ypr)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-23)


def test_spherical_project():
    xyz = np.random.default_rng(2).normal(size=(50000, 3)).astype(np.float32)
    want = np.asarray(jproj.spherical_project(jnp.asarray(xyz)))
    got = tproj.spherical_project(torch.tensor(xyz)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-22)
    assert (got == want).mean() > 0.9


def test_safe_norm_within_one_ulp():
    """XLA's CPU reduction fuses the sum of squares into FMAs; the port adds
    rounded squares, so the two differ by at most one ulp."""
    x = np.random.default_rng(3).normal(size=(1000, 3)).astype(np.float32)
    x[:10] = 0.0
    want = np.asarray(jproj.safe_norm(jnp.asarray(x)))
    got = tproj.safe_norm(torch.tensor(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_array_equal(got[:10], 0.0)


@pytest.mark.parametrize("wrap", [False, True])
def test_pack_bilinear_blocks_exact(wrap):
    img = np.random.default_rng(4).random((13, 22, 3)).astype(np.float32)
    want = np.asarray(jsamp.pack_bilinear_blocks(jnp.asarray(img), wrap=wrap))
    got = tsamp.pack_bilinear_blocks(torch.tensor(img), wrap=wrap).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wrap", [False, True])
def test_packed_rows_and_weights_exact(wrap):
    c = np.random.default_rng(5).uniform(-1.2, 1.2, (20000, 2)).astype(np.float32)
    want = jsamp.packed_rows_and_weights(jnp.asarray(c), 31, 64, wrap=wrap)
    got = tsamp.packed_rows_and_weights(torch.tensor(c), 31, 64, wrap=wrap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("wrap", [False, True])
def test_bilinear_sample_exact(packed, wrap):
    rng = np.random.default_rng(6)
    img = rng.random((31, 64, 3)).astype(np.float32)
    img[3:9, 10:30] = 0.0  # zero texels: the pure-black rule's input
    c = rng.uniform(-1.2, 1.2, (20000, 2)).astype(np.float32)
    if packed:
        want = jsamp.bilinear_sample_packed(
            jsamp.pack_bilinear_blocks(jnp.asarray(img), wrap=wrap), 31, 64,
            jnp.asarray(c), wrap=wrap)
        got = tsamp.bilinear_sample_packed(
            tsamp.pack_bilinear_blocks(torch.tensor(img), wrap=wrap), 31, 64,
            torch.tensor(c), wrap=wrap)
    else:
        want = jsamp.bilinear_sample(jnp.asarray(img), jnp.asarray(c), wrap=wrap)
        got = tsamp.bilinear_sample(torch.tensor(img), torch.tensor(c), wrap=wrap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_cast_packed_table_exact(dtype):
    blocks = np.random.default_rng(7).uniform(-0.2, 1.2, (500, 12)).astype(np.float32)
    want = np.asarray(
        jsamp.cast_packed_table(jnp.asarray(blocks), dtype).astype(jnp.float32))
    got = tsamp.cast_packed_table(torch.tensor(blocks), dtype).to(torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tsamp.resolve_descent_table("auto", 512, 1024) == \
        jsamp.resolve_descent_table("auto", 512, 1024)
    assert tsamp.resolve_descent_table("auto", 1024, 2048) == \
        jsamp.resolve_descent_table("auto", 1024, 2048)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(8)
    xyz, rgb = make_room(rng, n_per_wall=300, texture="checker")
    img = np.asarray(render_at(xyz, rgb, np.array([0.3, -0.2, 0.1], np.float32),
                               np.array([0.7, 0.0, 0.0], np.float32), (32, 64)))
    mask = np.ones(xyz.shape[0], bool)
    mask[::7] = False
    # three poses near the rendering pose
    t = np.array([[0.35, -0.15, 0.05], [0.2, -0.3, 0.15], [0.4, -0.1, 0.1]],
                 np.float32)
    ypr = np.array([[0.75, 0.02, -0.01], [0.6, -0.03, 0.02], [0.8, 0.0, 0.0]],
                   np.float32)
    return dict(xyz=xyz, rgb=rgb, img=img, mask=mask, t=t, ypr=ypr)


def _jax_value_and_grad(s, i, packed, wrap, mask):
    xyz, rgb, img = (jnp.asarray(s[k]) for k in ("xyz", "rgb", "img"))
    pm = jnp.asarray(mask) if mask is not None else None
    H, W, _ = img.shape
    blocks = jsamp.pack_bilinear_blocks(img, wrap=wrap)

    def f(p):
        if packed:
            return jloss.sampling_loss_packed(p, xyz, rgb, blocks, H, W, pm,
                                              wrap=wrap)
        return jloss.sampling_loss(p, xyz, rgb, img, pm, wrap=wrap)

    p = jloss.Pose(t=jnp.asarray(s["t"][i]), yaw=jnp.asarray(s["ypr"][i, 0]),
                   pitch=jnp.asarray(s["ypr"][i, 1]),
                   roll=jnp.asarray(s["ypr"][i, 2]))
    v, g = jax.value_and_grad(f)(p)
    return float(v), np.concatenate([np.asarray(g.t), np.asarray(
        [g.yaw, g.pitch, g.roll])])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("wrap", [False, True])
def test_sampling_loss_value_and_pose_grad(scene, packed, wrap):
    s = scene
    leaves = [torch.tensor(s["t"]), *(torch.tensor(s["ypr"][:, j])
                                      for j in range(3))]
    for x in leaves:
        x.requires_grad_(True)
    pose = tloss.Pose(*leaves)
    xyz, rgb, img = (torch.tensor(s[k]) for k in ("xyz", "rgb", "img"))
    pm = torch.tensor(s["mask"])
    H, W, _ = img.shape
    if packed:
        blocks = tsamp.pack_bilinear_blocks(img, wrap=wrap)
        v = tloss.sampling_loss_packed(pose, xyz, rgb, blocks, H, W, pm, wrap=wrap)
    else:
        v = tloss.sampling_loss(pose, xyz, rgb, img, pm, wrap=wrap)
    grads = torch.autograd.grad(v.sum(), leaves)
    g = torch.cat([grads[0], torch.stack(grads[1:], -1)], -1).numpy()
    for i in range(3):
        want_v, want_g = _jax_value_and_grad(s, i, packed, wrap, s["mask"])
        np.testing.assert_allclose(v[i].item(), want_v, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g[i], want_g, rtol=1e-5, atol=1e-6)


def test_all_masked_start_scores_inf_with_finite_grad(scene):
    """A start that samples nothing scores +inf; its gradient (and the other
    starts') stays finite, and JAX agrees on the value."""
    s = scene
    leaves = [torch.tensor(s["t"][:2]), *(torch.tensor(s["ypr"][:2, j])
                                          for j in range(3))]
    for x in leaves:
        x.requires_grad_(True)
    xyz, rgb, img = (torch.tensor(s[k]) for k in ("xyz", "rgb", "img"))
    # an all-black image: every sample is dropped by the pure-black rule
    dark = torch.zeros_like(img)
    v = torch.stack([
        tloss.sampling_loss(tloss.Pose(*[x[i] for x in leaves]), xyz, rgb,
                            im, None)
        for i, im in ((0, img), (1, dark))
    ])
    grads = torch.autograd.grad(v.sum(), leaves)
    assert np.isfinite(v[0].item()) and v[1].item() == np.inf
    for gr in grads:
        assert torch.isfinite(gr).all()
    want = jloss.sampling_loss(
        jloss.Pose(t=jnp.asarray(s["t"][1]), yaw=jnp.asarray(s["ypr"][1, 0]),
                   pitch=jnp.asarray(s["ypr"][1, 1]),
                   roll=jnp.asarray(s["ypr"][1, 2])),
        jnp.asarray(s["xyz"]), jnp.asarray(s["rgb"]), jnp.zeros_like(img.numpy()))
    assert float(want) == np.inf
