"""The port's staged path and descent speed modes against the JAX package's,
on the CPU.

One synthetic room (2,400 points padded to 4,096), a 64x128 main image and
its 32x64 init image, 8 candidate translations x 8 yaws (the room of
test_torch_pipeline.py).  Selections, survivor sets and winner indices must
be equal; poses agree within 1e-3 m / 1e-3 rad and losses within rtol 1e-4
at lr 0.01 and 20 iterations (the reference's descent amplifies ulp-level
differences at lr 0.1, ROADMAP Queue 3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu import solver as jsolver
from piccolo_tpu.init.refine import make_input as jmake_input
from piccolo_tpu.pipeline import localize_query as jlocalize
from piccolo_tpu.testing import render_at as jrender_at
from piccolo_tpu_torch import solver as tsolver
from piccolo_tpu_torch.harness.localize import _order_bounds, _pad_cloud
from piccolo_tpu_torch.init.candidates import (
    default_init_dict,
    generate_rot_points,
    generate_trans_points,
)
from piccolo_tpu_torch.init.refine import _pad_rows, make_input
from piccolo_tpu_torch.kernels.block_histogram import block_histogram
from piccolo_tpu_torch.pipeline import localize_query, localize_query_batch
from piccolo_tpu_torch.testing import make_room

torch.set_num_threads(2)

DESCENT = dict(num_iter=20, lr=0.01, patience=5, factor=0.8)


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
    # six starts: the staged init's own selection
    t0, y0 = make_input(img[::2, ::2].copy(), xyz_d, rgb_d, 6, d, "loss",
                        point_mask=mask_d, device="cpu")
    return dict(img=img, init=img[::2, ::2].copy(), xyz=xyz_d, rgb=rgb_d,
                mask=mask_d, trans=trans_p, rot=rot, valid=np.arange(16) < 8,
                lo=lo, hi=hi, gt_t=gt_t, init_dict=d, t0=t0, y0=y0)


def _jdescend(r, t0=None, y0=None, **kw):
    t0 = r["t0"] if t0 is None else t0
    y0 = r["y0"] if y0 is None else y0
    return jsolver.descend(*(jnp.asarray(a) for a in (
        r["img"], r["xyz"], r["rgb"], t0, y0, r["lo"], r["hi"], r["mask"])),
        masked=True, **dict(DESCENT, **kw))


def _tdescend(r, t0=None, y0=None, **kw):
    t0 = r["t0"] if t0 is None else t0
    y0 = r["y0"] if y0 is None else y0
    return tsolver.descend(r["img"], r["xyz"], r["rgb"], t0, y0, r["lo"],
                           r["hi"], r["mask"], masked=True, device="cpu",
                           **dict(DESCENT, **kw))


def _assert_close(got, want):
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.ypr.numpy(), np.asarray(want.ypr), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.lr.numpy(), np.asarray(want.lr))


@pytest.mark.parametrize("criterion,rate", [
    ("loss_histogram", None), ("loss", None), ("loss_histogram", 2)])
def test_make_input_matches_jax(room, criterion, rate):
    r = room
    d = dict(r["init_dict"], sample_rate_for_init=rate)
    args = (r["init"], r["xyz"], r["rgb"], 4, d, criterion, 8)
    want = jmake_input(*(jnp.asarray(a) for a in args[:3]), *args[3:],
                       point_mask=jnp.asarray(r["mask"]))
    # one block-histogram call for the histogram trim, none for "loss"
    block_histogram.launches = 0
    got = make_input(*args, point_mask=r["mask"], device="cpu")
    assert isinstance(got[0], np.ndarray) and got[0].shape == (4, 3)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert block_histogram.launches == 0  # CPU tensors: the plain version


def test_make_input_sampling_keeps_the_valid_draw(room):
    """sample_rate_for_init narrows the mask to the numpy draw over the
    valid points: with rate 1e9 no point is kept, so every pair scores +inf
    and the loss trim keeps the first pairs in grid order."""
    r = room
    d = dict(r["init_dict"], sample_rate_for_init=1e9)
    t, _ = make_input(r["init"], r["xyz"], r["rgb"], 4, d, "loss",
                      point_mask=r["mask"], device="cpu")
    trans = generate_trans_points(r["xyz"][r["mask"]], d)
    np.testing.assert_array_equal(t, trans[[0, 0, 0, 0]])


def test_pad_rows():
    a = torch.arange(15.0).reshape(5, 3)
    p, n = _pad_rows(a, 8)
    assert n == 5 and p.shape == (8, 3)
    assert torch.equal(p[5:], a[:1].expand(3, 3))
    assert _pad_rows(a, 5)[0] is a


def test_evaluate_poses_matches_jax(room):
    r = room
    want = jsolver.evaluate_poses(*(jnp.asarray(a) for a in (
        r["img"], r["xyz"], r["rgb"], r["t0"], r["y0"], r["mask"])),
        masked=True)
    got = tsolver.evaluate_poses(r["img"], r["xyz"], r["rgb"], r["t0"],
                                 r["y0"], r["mask"], masked=True, device="cpu")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-6)


def test_solve_matches_jax(room):
    r = room
    args = (r["img"], r["xyz"], r["rgb"], r["t0"], r["y0"], r["lo"], r["hi"],
            r["mask"])
    jt, jR, jl, jres = jsolver.solve(*(jnp.asarray(a) for a in args),
                                     **DESCENT)
    t, R, loss, res = tsolver.solve(*args, device="cpu", **DESCENT)
    assert int(torch.argmin(res.loss)) == int(jnp.argmin(jres.loss))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-3)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    _assert_close(res, jres)


def _survivors(phase1_loss, keep, valid=None):
    rank = np.where(valid, phase1_loss, np.inf) if valid is not None else (
        phase1_loss)
    return np.argsort(rank, kind="stable")[:keep]


@pytest.mark.parametrize("prune", [(8, 2), (12, 3)])
def test_prune_matches_jax(room, prune):
    """Same survivor set and order, survivors within tolerance, pruned rows
    frozen at their phase-1 state."""
    r = room
    k, m = prune
    p1_j = _jdescend(r, num_iter=k)
    p1_t = _tdescend(r, num_iter=k)
    order_j = _survivors(np.asarray(p1_j.loss), m)
    order_t = _survivors(p1_t.loss.numpy(), m)
    np.testing.assert_array_equal(order_t, order_j)
    want = _jdescend(r, prune=prune)
    got = _tdescend(r, prune=prune)
    _assert_close(got, want)
    dropped = np.setdiff1d(np.arange(6), order_t)
    assert torch.equal(got.t[dropped], p1_t.t[dropped])
    assert torch.equal(got.loss[dropped], p1_t.loss[dropped])
    assert torch.equal(got.lr[dropped], p1_t.lr[dropped])
    # survivors carry their optimizer state: they end where the unpruned
    # descent ends
    full = _tdescend(r)
    assert torch.equal(got.t[order_t], full.t[order_t])
    assert torch.equal(got.loss[order_t], full.loss[order_t])


def test_prune_keeps_clone_rows_out(room):
    """Rows marked invalid (clones of row 0) rank +inf: they never take a
    survivor slot, in the port as in JAX, although their phase-1 loss ties
    row 0's."""
    r = room
    t0, y0 = r["t0"].copy(), r["y0"].copy()
    t0[3:], y0[3:] = t0[0], y0[0]
    valid = np.arange(6) < 3
    p1 = _tdescend(r, t0=t0, y0=y0, num_iter=8)
    order = _survivors(p1.loss.numpy(), 3, valid)
    assert set(order) == {0, 1, 2}
    want = jsolver.descend(*(jnp.asarray(a) for a in (
        r["img"], r["xyz"], r["rgb"], t0, y0, r["lo"], r["hi"], r["mask"])),
        masked=True, prune=(8, 3), start_valid=jnp.asarray(valid), **DESCENT)
    got = _tdescend(r, t0=t0, y0=y0, prune=(8, 3), start_valid=valid)
    _assert_close(got, want)
    assert torch.equal(got.loss[3:], p1.loss[3:])


@pytest.mark.parametrize("multires", [(8, 2), (14, 4)])
def test_multires_matches_jax(room, multires):
    r = room
    _assert_close(_tdescend(r, multires=multires),
                  _jdescend(r, multires=multires))


@pytest.mark.parametrize("prune,multires,n_cand,traj,expect", [
    (None, None, 6, False, (None, None)),
    ((0, 2), None, 6, False, (None, None)),
    ((5, 6), None, 6, False, (None, None)),
    ((20, 2), None, 6, False, (None, None)),
    ((5, 2), None, 6, False, ((5, 2), None)),
    ((5, 0), None, 6, False, ValueError),
    ((5, 2), None, 6, True, ValueError),
    (None, (0, 2), 6, False, (None, None)),
    (None, (5, 1), 6, False, ValueError),
    (None, (20, 2), 6, False, ValueError),
    ((5, 2), (5, 2), 6, False, ValueError),
    (None, (5, 2), 6, True, ValueError),
    (None, (5, 2), 6, False, (None, (5, 2))),
])
def test_mode_validators_match_jax(prune, multires, n_cand, traj, expect):
    def run(mod):
        p = mod._check_prune(prune, 20, n_cand, traj)
        return p, mod._check_multires(multires, 20, p, traj)

    if expect is ValueError:
        for mod in (jsolver, tsolver):
            with pytest.raises(ValueError):
                run(mod)
    else:
        assert run(tsolver) == run(jsolver) == expect


def _query_both(r, **kw):
    args = (r["init"], r["img"], r["xyz"], r["rgb"], r["trans"], r["rot"],
            r["valid"], r["lo"], r["hi"], r["mask"])
    qkw = dict(num_intermediate=8, num_input=4, masked=True, **DESCENT, **kw)
    want = jlocalize(*(jnp.asarray(a) for a in args), **qkw)
    return localize_query(*args, device="cpu", **qkw), want


@pytest.mark.parametrize("mode", [dict(descent_prune=(8, 2)),
                                  dict(descent_multires=(8, 2))])
def test_localize_query_modes_match_jax(room, mode):
    got, want = _query_both(room, **mode)
    np.testing.assert_array_equal(got.start_t.numpy(), np.asarray(want.start_t))
    np.testing.assert_array_equal(got.start_ypr.numpy(),
                                  np.asarray(want.start_ypr))
    assert int(got.winner) == int(want.winner)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.cand_loss.numpy(),
                               np.asarray(want.cand_loss), rtol=1e-4)


def test_localize_query_prune_keeps_clone_rows_out(room):
    """Two valid pairs for four starts: the clone rows of the scarce-pair
    fallback never survive the prune, in the port as in JAX."""
    r = room
    rot = r["rot"][:2]
    valid = np.arange(16) == 4
    args = (r["init"], r["img"], r["xyz"], r["rgb"], r["trans"], rot, valid,
            r["lo"], r["hi"], r["mask"])
    qkw = dict(num_intermediate=8, num_input=4, masked=True,
               descent_prune=(8, 2), **DESCENT)
    want = jlocalize(*(jnp.asarray(a) for a in args), **qkw)
    got = localize_query(*args, device="cpu", **qkw)
    base = localize_query(*args, device="cpu",
                          **dict(qkw, descent_prune=None, num_iter=8))
    # rows 0 and 1 are the valid starts and survive; rows 2, 3 are clones
    # frozen at their phase-1 state
    assert torch.equal(got.cand_t[2:], base.cand_t[2:])
    assert int(got.winner) == int(want.winner)
    np.testing.assert_allclose(got.cand_loss.numpy(),
                               np.asarray(want.cand_loss), rtol=1e-4)


def test_localize_query_batch_equals_single_queries(room):
    r = room
    img2 = np.roll(r["img"], 16, axis=1)
    mains = np.stack([r["img"], img2])
    inits = mains[:, ::2, ::2].copy()
    rest = (r["xyz"], r["rgb"], r["trans"], r["rot"], r["valid"], r["lo"],
            r["hi"], r["mask"])
    kw = dict(num_intermediate=8, num_input=4, masked=True, device="cpu",
              descent_prune=(8, 2), **DESCENT)
    batch = localize_query_batch(inits, mains, *rest, **kw)
    assert batch.t.shape == (2, 3) and batch.cand_t.shape == (2, 4, 3)
    for q in range(2):
        one = localize_query(inits[q], mains[q], *rest, **kw)
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(batch, f.name)[q], getattr(one, f.name))
    with pytest.raises(ValueError, match="trajectories"):
        localize_query_batch(inits, mains, *rest, **dict(kw, trajectory=True))
