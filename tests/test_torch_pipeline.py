"""The port's fused query against the JAX package's, end to end on the CPU.

One synthetic room (2,400 points padded to 4,096), a 64x128 main image and
its 32x64 init image, 8 candidate translations padded to 16, 8 yaws; the
query keeps the top 8, then 4 starts descend for 20 iterations.  For each
configuration both packages must select the same starts (exactly: they are
grid values) and the same winner, and agree on the winner pose within
1e-3 m / 1e-3 rad and on the candidates' final losses within rtol 1e-4
(Adam turns the ulp differences of the loss into small trajectory drift).

The parity runs descend at lr 0.01.  At the reference's lr 0.1 the descent
on this scene is chaotic in the reference itself: moving one start by one
ulp moves JAX's own final pose by more than the 1e-3 tolerance (shown
below), so no port can be held to it there.  The port's step-1 gradients
agree with JAX's, and at lr 0.1 the port still recovers the pose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu import loss as jloss
from piccolo_tpu.ops import sampling as jsamp
from piccolo_tpu.solver import descend as jdescend

from piccolo_tpu.init.refine import build_hist_plan as jbuild_hist_plan
from piccolo_tpu.kernels.slab_sampling import build_grid_plan as jbuild_grid_plan
from piccolo_tpu.pipeline import localize_query as jlocalize
from piccolo_tpu.testing import render_at as jrender_at
from piccolo_tpu_torch import build_grid_plan, build_hist_plan, localize_query
from piccolo_tpu_torch import loss as tloss
from piccolo_tpu_torch.convert import grid_plan_from_numpy, hist_plan_from_numpy
from piccolo_tpu_torch.harness.localize import _order_bounds, _pad_cloud
from piccolo_tpu_torch.init.candidates import (
    default_init_dict,
    generate_rot_points,
    generate_trans_points,
)
from piccolo_tpu_torch.kernels.block_histogram import block_histogram
from piccolo_tpu_torch.kernels.slab_sampling import slab_group_sums_f32
from piccolo_tpu_torch.ops import sampling as tsamp
from piccolo_tpu_torch.testing import make_room

torch.set_num_threads(2)

KW = dict(num_intermediate=8, num_input=4, num_iter=20, lr=0.01, patience=5,
          factor=0.8, masked=True)


@pytest.fixture(scope="module")
def room():
    rng = np.random.default_rng(21)
    xyz, rgb = make_room(rng, n_per_wall=400, texture="checker")
    gt_t = np.array([0.4, -0.3, 0.1], np.float32)
    gt_ypr = np.array([2.0, 0.0, 0.0], np.float32)
    img = np.asarray(jrender_at(xyz, rgb, gt_t, gt_ypr, (64, 128)))
    d = default_init_dict(xy_only=True, num_trans=8, yaw_only=True, num_yaw=8,
                          z_prior=None, num_split_h=4, num_split_w=4)
    trans = generate_trans_points(xyz, d)[:8]
    rot = generate_rot_points(d)
    xyz_d, rgb_d, mask_d = (x.numpy() for x in _pad_cloud(xyz, rgb, "cpu"))
    lo, hi = _order_bounds(xyz, 0.05)
    trans_p = np.concatenate([trans, np.zeros((8, 3), np.float32)])
    valid = np.arange(16) < 8
    return dict(img=img, init=img[::2, ::2].copy(), xyz=xyz_d, rgb=rgb_d,
                mask=mask_d, trans=trans_p, rot=rot, valid=valid, lo=lo, hi=hi,
                gt_t=gt_t)


def _jax_plans(r, n_trans):
    gp = jbuild_grid_plan(jnp.asarray(r["xyz"]), jnp.asarray(r["rgb"]),
                          jnp.asarray(r["mask"]), jnp.asarray(r["trans"][:n_trans]),
                          jnp.asarray(r["rot"]), 32, 64)
    hp = jbuild_hist_plan(jnp.asarray(r["xyz"]), jnp.asarray(r["rgb"]),
                          jnp.asarray(r["trans"][:n_trans]), jnp.asarray(r["rot"]),
                          32, 64, point_mask=jnp.asarray(r["mask"]))
    return gp, hp


def _carry(gp, hp):
    plan = grid_plan_from_numpy(
        [np.asarray(f) for f in gp.fields], [np.asarray(w) for w in gp.windows],
        gp.n_pairs, gp.height, gp.width, gp.wrap, gp.window, gp.block,
        device="cpu")
    hplan = hist_plan_from_numpy(np.asarray(hp.planes), hp.n_pairs, hp.height,
                                 hp.width, device="cpu")
    return plan, hplan


def _run_both(r, jkw=None, tkw=None, rot=None, valid=None, **kw):
    rot = r["rot"] if rot is None else rot
    valid = r["valid"] if valid is None else valid
    args = (r["init"], r["img"], r["xyz"], r["rgb"], r["trans"], rot, valid,
            r["lo"], r["hi"], r["mask"])
    want = jlocalize(*(jnp.asarray(a) for a in args), **KW, **kw, **(jkw or {}))
    got = localize_query(*args, **KW, **kw, **(tkw or {}), device="cpu")
    return got, want


def _assert_same(got, want):
    np.testing.assert_array_equal(got.start_t.numpy(), np.asarray(want.start_t))
    np.testing.assert_array_equal(got.start_ypr.numpy(), np.asarray(want.start_ypr))
    assert int(got.winner) == int(want.winner)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-3)
    w = int(want.winner)
    np.testing.assert_allclose(got.cand_ypr[w].numpy(),
                               np.asarray(want.cand_ypr)[w], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.cand_loss.numpy(), np.asarray(want.cand_loss),
                               rtol=1e-4)


def test_no_plan(room):
    got, want = _run_both(room)
    _assert_same(got, want)


def test_port_recovers_pose_at_reference_lr(room):
    r = room
    kw = dict(KW, lr=0.1)
    res = localize_query(r["init"], r["img"], r["xyz"], r["rgb"], r["trans"],
                         r["rot"], r["valid"], r["lo"], r["hi"], r["mask"],
                         device="cpu", **kw)
    assert np.linalg.norm(res.t.numpy() - r["gt_t"]) < 0.2


def test_jax_plans_carried_across(room):
    gp, hp = _jax_plans(room, 8)
    plan, hplan = _carry(gp, hp)
    got, want = _run_both(room, jkw=dict(plan=gp, hist_plan=hp),
                          tkw=dict(plan=plan, hist_plan=hplan))
    _assert_same(got, want)


def test_port_built_plans(room):
    r = room
    gp, hp = _jax_plans(r, 8)
    plan = build_grid_plan(r["xyz"], r["rgb"], r["mask"], r["trans"][:8],
                           r["rot"], 32, 64, device="cpu")
    hplan = build_hist_plan(r["xyz"], r["rgb"], r["trans"][:8], r["rot"], 32,
                            64, point_mask=r["mask"], device="cpu")
    got, want = _run_both(r, jkw=dict(plan=gp, hist_plan=hp),
                          tkw=dict(plan=plan, hist_plan=hplan))
    _assert_same(got, want)


def test_criterion_loss(room):
    got, want = _run_both(room, criterion="loss")
    _assert_same(got, want)


def test_partial_plan_with_gather_tail(room):
    gp, hp = _jax_plans(room, 4)
    plan, _ = _carry(gp, hp)
    got, want = _run_both(room, jkw=dict(plan=gp), tkw=dict(plan=plan),
                          plan_tail="xla")
    _assert_same(got, want)


def test_trajectory(room):
    (got, traj), (want, jtraj) = _run_both(room, trajectory=True)
    _assert_same(got, want)
    assert traj.t.shape == (4, 20, 3)
    np.testing.assert_allclose(traj.t.numpy(), np.asarray(jtraj.t), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(traj.yaw.numpy(), np.asarray(jtraj.yaw), rtol=0,
                               atol=1e-3)


def test_scarce_valid_pairs_clone_the_best_start(room):
    """2 valid pairs for 4 starts: the trailing starts are clones of the
    best valid one, never padding poses.  (The valid row is an interior
    grid point: from the rows next to a wall the descent runs into the
    clamp box, where it is as ill-conditioned as at lr 0.1.)"""
    valid = np.arange(16) == 4
    got, want = _run_both(room, rot=room["rot"][:2], valid=valid)
    _assert_same(got, want)
    st = got.start_t.numpy()
    assert np.all(st[2:] == st[0])
    assert np.all(st == room["trans"][4])


def test_guards_and_cpu_launch_counters(room):
    r = room
    gp, hp = _jax_plans(r, 8)
    plan, hplan = _carry(gp, hp)
    args = (r["init"], r["img"], r["xyz"], r["rgb"], r["trans"], r["rot"],
            r["valid"], r["lo"], r["hi"], r["mask"])
    with pytest.raises(ValueError, match="not supported"):
        localize_query(*args, criterion="hist", device="cpu")
    with pytest.raises(ValueError, match="seam_wrap"):
        localize_query(*args, plan=plan, seam_wrap=True, device="cpu")
    with pytest.raises(ValueError, match="different grids"):
        localize_query(*args[:5], r["rot"][:3], *args[6:], plan=plan,
                       device="cpu")
    with pytest.raises(ValueError, match="init image"):
        localize_query(r["img"], *args[1:], hist_plan=hplan, device="cpu")
    with pytest.raises(ValueError, match="stale plan"):
        localize_query(*args[:5], r["rot"][:3], *args[6:], hist_plan=hplan,
                       device="cpu")
    with pytest.raises(ValueError, match="rgb rebind"):
        localize_query(*args, hist_plan=hplan, plan_refresh_rgb=True,
                       device="cpu")
    localize_query(*args, plan=plan, hist_plan=hplan, device="cpu", **KW)
    # on the CPU every wrapper runs its plain version: no kernel launched
    assert block_histogram.launches == 0
    assert slab_group_sums_f32.launches == 0


def _starts(r):
    want = jlocalize(*(jnp.asarray(a) for a in (
        r["init"], r["img"], r["xyz"], r["rgb"], r["trans"], r["rot"],
        r["valid"], r["lo"], r["hi"], r["mask"])), **dict(KW, num_iter=1))
    return np.asarray(want.start_t), np.asarray(want.start_ypr)


def test_step1_gradients_match_jax(room):
    """At the selected starts the port's first-step loss and pose gradient
    agree with jax.grad (rtol 1e-5, atol 1e-6)."""
    r = room
    t0, y0 = _starts(r)
    img = r["img"]
    H, W, _ = img.shape
    blocks_j = jsamp.pack_bilinear_blocks(jnp.asarray(img))
    leaves = [torch.tensor(t0)] + [torch.tensor(y0[:, j]) for j in range(3)]
    for x in leaves:
        x.requires_grad_(True)
    v = tloss.sampling_loss_packed(
        tloss.Pose(*leaves), torch.tensor(r["xyz"]), torch.tensor(r["rgb"]),
        tsamp.pack_bilinear_blocks(torch.tensor(img)), H, W,
        torch.tensor(r["mask"]))
    g = torch.autograd.grad(v.sum(), leaves)
    got = torch.cat([g[0], torch.stack(g[1:], -1)], -1).numpy()

    def f(p):
        return jloss.sampling_loss_packed(
            p, jnp.asarray(r["xyz"]), jnp.asarray(r["rgb"]), blocks_j, H, W,
            jnp.asarray(r["mask"]))

    for i in range(t0.shape[0]):
        val, gj = jax.value_and_grad(f)(jloss.Pose(
            jnp.asarray(t0[i]), *(jnp.asarray(y0[i, j]) for j in range(3))))
        want = np.concatenate([np.asarray(gj.t),
                               np.asarray([gj.yaw, gj.pitch, gj.roll])])
        np.testing.assert_allclose(v[i].item(), float(val), rtol=1e-5)
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-6)


def test_reference_descent_at_lr_0_1_amplifies_one_ulp(room):
    """Why the parity runs use lr 0.01: JAX's own 20-iteration descent at
    lr 0.1 moves by more than 1e-3 when one start moves by one ulp."""
    r = room
    t0, y0 = _starts(r)
    t1 = t0.copy()
    t1[:, 0] = np.nextafter(t1[:, 0], np.float32(np.inf))
    ends = [np.asarray(jdescend(
        jnp.asarray(r["img"]), jnp.asarray(r["xyz"]), jnp.asarray(r["rgb"]),
        jnp.asarray(t), jnp.asarray(y0), jnp.asarray(r["lo"]),
        jnp.asarray(r["hi"]), jnp.asarray(r["mask"]), num_iter=20, lr=0.1,
        patience=5, factor=0.8, masked=True).t) for t in (t0, t1)]
    assert np.abs(ends[0] - ends[1]).max() > 1e-3
