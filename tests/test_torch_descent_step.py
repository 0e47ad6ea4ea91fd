"""The descent step's plain version (``kernels/descent_step.py``), on the CPU.

The card's step is two CUDA kernels; their plain PyTorch version is held
here against what it replaces, under one thread:
  * its sums against ``loss.sampling_partials_packed`` and its loss and
    pose gradient against ``torch.autograd.grad`` of ``masked_mean`` of
    them, over f32, bf16 and uint8 tables, the seam's wrap on and off,
    masked and unmasked clouds, 1 and 6 starts on one table, and 4 streams
    stacked through ``row_offset`` (each against its own table), with
    points on the clip's edges, at the pole (x = y = 0), on black texels,
    and a start that samples nothing.  The count is exact and the total and
    loss bit-equal (the forward is the loss's own code); the gradient
    agrees within 1e-5 of each leaf's largest component (the same terms,
    added in another order);
  * its Adam, plateau and clamp tail against ``optim.adam_plateau_step``
    and ``torch.clamp``, bit for bit;
  * one step and a 40-step descent against the autograd step;
  * which step the solver takes: the autograd step on the CPU, under
    anomaly detection and for an (R, N, 3) stack of rooms, the kernels on
    a card's single cloud; and ``_run`` counts its steps;
  * the reference itself: the plain version's loss and pose gradient
    against ``jax.value_and_grad`` of the JAX package's
    ``sampling_loss_packed``, and one plain step against one step of the
    JAX package's descent, start by start on the same numpy inputs, at
    ``tests/test_torch_pipeline.py``'s step-1 bounds (rtol 1e-5, atol
    1e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu import loss as jloss
from piccolo_tpu import optim as joptim
from piccolo_tpu import solver as jsolver
from piccolo_tpu.ops import sampling as jsamp

from piccolo_tpu_torch import solver
from piccolo_tpu_torch.kernels import descent_step as K
from piccolo_tpu_torch.loss import (
    Pose,
    masked_mean,
    sampling_partials_packed,
)
from piccolo_tpu_torch.ops.projection import spherical_project
from piccolo_tpu_torch.optim import adam_plateau_step, init_adam_plateau
from piccolo_tpu_torch.testing import make_room, render_at
from piccolo_tpu_torch.utils import profiling

torch.set_num_threads(1)

H, W = 24, 48
GT_T = np.float32([0.3, -0.2, 0.1])
GRAD_RTOL = 1e-5  # of each leaf's largest component


def _edge_points():
    """Ten points that, seen from t = 0 with no rotation, land exactly on
    the clip's edges (two each at u or v = +-0.99 in f32) and at the two
    poles (x = y = 0)."""
    found = []
    for axis, target in ((1, 0.99), (1, -0.99), (0, 0.99), (0, -0.99)):
        if axis == 1:  # v = 2 theta / pi - 1
            theta = (target + 1) * math.pi / 2
            ang = theta + np.arange(-4000, 4000) * 2e-9
            pts = np.stack([np.sin(ang), np.zeros_like(ang), np.cos(ang)], 1)
        else:  # u = 1 - phi / pi with phi = atan2(y, x) + pi
            phi = (1 - target) * math.pi - math.pi
            ang = phi + np.arange(-4000, 4000) * 2e-9
            pts = np.stack([np.cos(ang), np.sin(ang), np.full_like(ang, 0.3)],
                           1)
        pts = torch.tensor(pts * 1.5, dtype=torch.float32)
        coords = spherical_project(pts)
        hit = coords[:, axis] == torch.tensor(target, dtype=torch.float32)
        assert int(hit.sum()) >= 2, (axis, target)
        found.append(pts[hit][:2])
    found.append(torch.tensor([[0.0, 0.0, 0.8], [0.0, 0.0, -0.8]]))
    return torch.cat(found)


def _scene(seed=0, black=True):
    """A checker room, its panorama with a black patch, and the edge
    points in colours the panorama does not hold."""
    rng = np.random.default_rng(seed)
    xyz, rgb = make_room(rng, n_per_wall=300, texture="checker")
    img = render_at(xyz, rgb, GT_T, np.float32([0.5, 0, 0]), (H, W),
                    device="cpu")
    img = img.clamp_min(0.02)  # no black texel but the patch's
    if black:
        img[4:10, 10:20] = 0.0
    edge = _edge_points()
    xyz = torch.cat([torch.tensor(xyz), edge])
    rgb = torch.cat([torch.tensor(rgb), torch.full((edge.shape[0], 3), 0.7)])
    return xyz, rgb, img, rng


def _starts(S, rng):
    t = GT_T + rng.uniform(-0.3, 0.3, (S, 3)).astype(np.float32)
    ypr = np.zeros((S, 3), np.float32)
    ypr[:, 0] = 0.5 + rng.uniform(-0.4, 0.4, S)
    ypr[:, 1:] = rng.uniform(-0.1, 0.1, (S, 2))
    t, ypr = torch.tensor(t), torch.tensor(ypr)
    # start 0 sits at the edge points' origin, the room's centre, unrotated
    t[0] = 0.0
    ypr[0] = 0.0
    return t, ypr


def _inputs(dtype, wrap, masked, S, stacked, seed=0):
    xyz, rgb, img, rng = _scene(seed)
    K_ = stacked or 1
    imgs = [img] + [img.roll(7 * k, 1) for k in range(1, K_)]
    if stacked:
        imgs[-1] = torch.zeros_like(img)  # this stream samples nothing
    tables = [solver._packed_table(im, dtype, wrap) for im in imgs]
    offset = None
    if stacked:
        offset = (torch.arange(K_, dtype=torch.int32)
                  * ((H + 1) * (W + 1)))[:, None]
    mask = None
    if masked:
        mask = torch.tensor(rng.random(xyz.shape[0]) < 0.8)
        mask[-10:] = True  # the edge points
    lo = torch.tensor([-2.5, -1.5, -1.0])
    hi = torch.tensor([2.5, 1.5, 1.0])
    x = solver.StepInputs(torch.cat(tables), xyz, rgb, mask, lo, hi, offset)
    s = solver.StepStatics(H, W, 3, 0.8, wrap)
    t, ypr = _starts(S, rng)
    return x, s, tables, t, ypr


def _autograd(x, s, tables, t, ypr, stacked):
    """(total, count, loss, grads) by autograd, each start against its own
    table."""
    rows = range(t.shape[0]) if stacked else [slice(None)]
    out = []
    for r in rows:
        leaves = [t[r].clone(), ypr[r, 0].clone(), ypr[r, 1].clone(),
                  ypr[r, 2].clone()]
        if stacked:
            leaves = [a.reshape((1,) + a.shape) for a in leaves]
        leaves = [a.requires_grad_(True) for a in leaves]
        total, count = sampling_partials_packed(
            Pose(*leaves), x.xyz, x.rgb, tables[r if stacked else 0],
            s.height, s.width, x.point_mask, wrap=s.wrap)
        loss = masked_mean(total, count)
        grads = torch.autograd.grad(loss.sum(), leaves)
        out.append((total.detach(), count, loss.detach(), grads))
    total, count, loss, grads = zip(*out)
    return (torch.cat(total), torch.cat(count), torch.cat(loss),
            [torch.cat(g) for g in zip(*grads)])


CASES = [(dtype, wrap, masked, S, 0)
         for dtype in ("float32", "bfloat16", "uint8")
         for wrap in (False, True) for masked in (False, True)
         for S in (1, 6)]
CASES += [(dtype, wrap, True, 4, 4) for dtype in ("float32", "bfloat16",
                                                   "uint8")
          for wrap in (False, True)]


@pytest.mark.parametrize("dtype,wrap,masked,S,stacked", CASES)
def test_plain_sums_and_gradient_against_autograd(dtype, wrap, masked, S,
                                                  stacked):
    x, s, tables, t, ypr = _inputs(dtype, wrap, masked, S, stacked)
    total, count, loss, grads = _autograd(x, s, tables, t, ypr, stacked)
    sums = K.partials_plain(x, s, t, ypr[:, 0], ypr[:, 1], ypr[:, 2])
    assert torch.equal(sums[:, 1].to(torch.int64), count)
    assert torch.equal(sums[:, 0], total)
    got_loss, got = K.pose_gradient(sums, t, ypr[:, 0], ypr[:, 1], ypr[:, 2])
    assert torch.equal(got_loss, loss)
    for a, b in zip(got.leaves(), grads):
        tol = GRAD_RTOL * float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= tol, (a, b)
    if stacked:  # the black stream: +inf and no gradient
        assert count[-1] == 0 and math.isinf(float(got_loss[-1]))
        assert all(float(g[-1].abs().max()) == 0.0 for g in got.leaves())


def test_edge_points_are_seen():
    """Start 0 sees the edge points where they were made to land, and they
    sample texels that are not black, so their gates are exercised."""
    x, s, tables, t, ypr = _inputs("float32", False, False, 1, 0)
    edge = x.xyz[-10:] - t[0]
    coords = spherical_project(edge)
    on_edge = (coords.abs() == torch.tensor(0.99)).any(-1)
    assert int(on_edge.sum()) >= 4
    assert (edge[-2:, :2] == 0).all()  # the pole


def test_all_masked_samples_nothing():
    x, s, tables, t, ypr = _inputs("bfloat16", False, True, 6, 0)
    x = x._replace(point_mask=torch.zeros_like(x.point_mask))
    sums = K.partials_plain(x, s, t, ypr[:, 0], ypr[:, 1], ypr[:, 2])
    loss, grads = K.pose_gradient(sums, t, ypr[:, 0], ypr[:, 1], ypr[:, 2])
    assert torch.isinf(loss).all()
    assert all(float(g.abs().max()) == 0.0 for g in grads.leaves())


def _random_state(S, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    params = Pose(t=r(S, 3), yaw=r(S), pitch=r(S), roll=r(S))
    grads = Pose(t=r(S, 3), yaw=r(S), pitch=r(S), roll=r(S))
    state = init_adam_plateau(params, 0.1)
    state.m = Pose(t=r(S, 3) * 0.1, yaw=r(S) * 0.1, pitch=r(S) * 0.1,
                   roll=r(S) * 0.1)
    state.v = Pose(t=r(S, 3).abs() * 0.01, yaw=r(S).abs() * 0.01,
                   pitch=r(S).abs() * 0.01, roll=r(S).abs() * 0.01)
    state.count = torch.randint(0, 50, (S,), generator=g, dtype=torch.int32)
    state.lr = 0.1 * torch.rand(S, generator=g) + 1e-3
    state.best = torch.rand(S, generator=g)
    state.best[0] = math.inf
    state.num_bad = torch.randint(0, 6, (S,), generator=g, dtype=torch.int32)
    loss = torch.rand(S, generator=g)
    loss[1] = math.inf
    loss[2] = state.best[2]
    return params, grads, state, loss


@pytest.mark.parametrize("box", ["shared", "per_start"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_tail_is_adam_plateau_step_bit_for_bit(seed, box):
    """The plain version's Adam + plateau + clamp equals
    ``optim.adam_plateau_step`` followed by the solver's clamp."""
    S = 8
    params, grads, state, loss = _random_state(S, seed)
    lo = torch.full((3,), -0.5) if box == "shared" else -torch.rand(S, 3)
    hi = torch.full((3,), 0.5) if box == "shared" else torch.rand(S, 3)
    want_p, want_st = adam_plateau_step(params, grads, state, loss, 3, 0.7)
    want_p.t = torch.clamp(want_p.t, lo, hi)
    got = K.tail_plain(solver._state_leaves(params, state), grads, loss, lo,
                       hi, 3, 0.7)
    for a, b in zip(got, solver._state_leaves(want_p, want_st)):
        assert a.dtype == b.dtype and torch.equal(a, b), (a, b)


def test_one_plain_step_against_the_autograd_step():
    """One step from a fresh state: the same loss bits, the same integer
    state, and every pose leaf within 1e-6 (Adam's first step is lr times
    the gradient's sign, so each leaf moves by 0.1 either way)."""
    x, s, tables, t, ypr = _inputs("bfloat16", False, True, 6, 0)
    params = Pose(t=t, yaw=ypr[:, 0], pitch=ypr[:, 1], roll=ypr[:, 2])
    state = init_adam_plateau(params, 0.1)
    want_p, want_st, want_loss = solver._make_step(x, s)(params, state)
    leaves = solver._contiguous(solver._state_leaves(params, state))
    loss = torch.empty(6)
    K.descent_step(x, s, leaves, loss, None)  # CPU tensors: the plain step
    assert torch.equal(loss, want_loss)
    want = solver._state_leaves(want_p, want_st)
    for a, b in zip(leaves, want):
        assert float((a - b).abs().max()) <= 1e-6
    for i in (12, 13, 14, 15):
        assert torch.equal(leaves[i], want[i])
    assert K.descent_step.launches == 0


def test_plain_descent_near_the_autograd_descent():
    """40 steps from 6 starts: each start's final t within 1e-3 m and
    angles within 1e-3 rad of the autograd step's, the same best start."""
    x, s, tables, t, ypr = _inputs("float32", False, True, 6, 0, seed=1)
    params = Pose(t=t, yaw=ypr[:, 0], pitch=ypr[:, 1], roll=ypr[:, 2])
    state = init_adam_plateau(params, 0.05)
    step = solver._make_step(x, s)
    leaves = solver._contiguous(solver._state_leaves(params, state))
    loss = torch.empty(6)
    for _ in range(40):
        params, state, want_loss = step(params, state)
        K.descent_step(x, s, leaves, loss, None)
    assert float((leaves[0] - params.t).abs().max()) < 1e-3
    for a, b in zip(leaves[1:4], params.leaves()[1:]):
        assert float((a - b).abs().max()) < 1e-3
    assert int(torch.argmin(loss)) == int(torch.argmin(want_loss))


class _CardLike:
    """Stands in for a card tensor of starts: ``engages`` reads only its
    device and shape."""

    device = torch.device("cuda")

    def __init__(self, *shape):
        self.shape = torch.Size(shape)

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_engages_on_a_cards_single_cloud(dtype):
    x, s, tables, t, ypr = _inputs(dtype, True, True, 4, 4)
    assert K.engages(x, _CardLike(4, 3))
    x, s, tables, t, ypr = _inputs(dtype, False, False, 6, 0)
    assert K.engages(x, _CardLike(6, 3))
    assert K.engages(x._replace(lo=x.lo.expand(6, 3)), _CardLike(6, 3))


def test_the_autograd_step_stays_where_the_kernels_do_not_go():
    """The CPU, anomaly detection and an (R, N, 3) stack of rooms keep the
    autograd step."""
    x, s, tables, t, ypr = _inputs("bfloat16", False, True, 6, 0)
    assert not K.engages(x, t)  # the CPU
    with torch.autograd.set_detect_anomaly(True):
        assert not K.engages(x, _CardLike(6, 3))
    rooms = x._replace(xyz=x.xyz.expand(2, -1, -1),
                       rgb=x.rgb.expand(2, -1, -1),
                       point_mask=x.point_mask.expand(2, -1),
                       lo=x.lo[None, None], hi=x.hi[None, None])
    assert not K.engages(rooms, _CardLike(2, 6, 3))
    assert not K.engages(x._replace(blocks=x.blocks.double()),
                         _CardLike(6, 3))


def test_run_counts_its_steps(tmp_path):
    """While tracing, ``_run`` stores ``descent.steps_plain`` (the CPU) with
    its number of steps, on the open request."""
    x, s, tables, t, ypr = _inputs("float32", False, True, 6, 0)
    params = Pose(t=t, yaw=ypr[:, 0], pitch=ypr[:, 1], roll=ypr[:, 2])
    state = init_adam_plateau(params, 0.1)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profiling.request("service.request") as req:
            solver._run(x, s, params, state, 7)
        recs = profiling.span_records(req.start)
    counts = [r for r in recs if r.name.startswith("descent.steps")]
    assert [(r.name, r.n, r.requests) for r in counts] == [
        ("descent.steps_plain", 7, req.requests)]


def test_choosing_the_step_imports_nothing_slow():
    """``engages`` and the wrapper's checks leave sympy unimported:
    ``torch.broadcast_shapes`` imports it at its first call (5 s of a
    service's set-up on the card's host)."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "from piccolo_tpu_torch import solver\n"
        "from piccolo_tpu_torch.kernels import descent_step as K\n"
        "x = solver.StepInputs(torch.zeros(8, 12), torch.zeros(10, 3),\n"
        "    torch.zeros(10, 3), None, torch.zeros(3), torch.ones(1, 3),\n"
        "    None)\n"
        "class T:\n"
        "    device = torch.device('cuda')\n"
        "    shape = torch.Size([6, 3])\n"
        "    def dim(self):\n"
        "        return 2\n"
        "assert K.engages(x, T())\n"
        "assert 'sympy' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_plain_step_against_the_jax_package(dtype, wrap):
    """Six starts, the poles among the cloud, a masked cloud: the JAX
    package packs and casts the same table; ``partials_plain`` +
    ``pose_gradient`` give each start's loss and gradient as
    ``jax.value_and_grad`` of its ``sampling_loss_packed`` does, and one
    ``descent_step_plain`` step gives its descent step's pose, moments,
    count, learning rate, best and plateau counter.  The eight points
    exactly on the clip's edges are left out: at a tie ``jnp.clip`` passes
    half the gradient and ``torch.clamp`` all of it, as the port's
    autograd step does (held above), which moves start 0's gradient by up
    to 5%."""
    x, s, tables, t, ypr = _inputs(dtype, wrap, True, 6, 0)
    keep = torch.ones(x.xyz.shape[0], dtype=torch.bool)
    keep[-10:-2] = False  # _edge_points' clip edges; the poles stay
    x = x._replace(xyz=x.xyz[keep], rgb=x.rgb[keep],
                   point_mask=x.point_mask[keep])
    img = _scene(0)[2]
    blocks_j = jsamp.cast_packed_table(
        jsamp.pack_bilinear_blocks(jnp.asarray(img.numpy()), wrap=wrap),
        dtype)
    assert np.array_equal(np.asarray(blocks_j.astype(jnp.float32)),
                          tables[0].to(torch.float32).numpy())
    xyz, rgb, mask = (jnp.asarray(a.numpy()) for a in (x.xyz, x.rgb,
                                                       x.point_mask))
    lo, hi = jnp.asarray(x.lo.numpy()), jnp.asarray(x.hi.numpy())

    sums = K.partials_plain(x, s, t, ypr[:, 0], ypr[:, 1], ypr[:, 2])
    loss, grads = K.pose_gradient(sums, t, ypr[:, 0], ypr[:, 1], ypr[:, 2])
    got = torch.cat([grads.t, torch.stack(grads.leaves()[1:], -1)],
                    -1).numpy()
    params = Pose(t=t, yaw=ypr[:, 0], pitch=ypr[:, 1], roll=ypr[:, 2])
    leaves = solver._contiguous(solver._state_leaves(
        params, init_adam_plateau(params, 0.1)))
    stepped, step_loss = K.descent_step_plain(x, s, leaves)

    def f(p):
        return jloss.sampling_loss_packed(p, xyz, rgb, blocks_j, H, W, mask,
                                          wrap=wrap)

    jstep = jsolver._make_step(blocks_j, H, W, xyz, rgb, lo, hi, mask,
                               s.patience, s.factor, False, wrap)
    for i in range(6):
        p = jloss.Pose(jnp.asarray(t[i].numpy()),
                       *(jnp.asarray(ypr[i, j].numpy()) for j in range(3)))
        val, gj = jax.value_and_grad(f)(p)
        want = np.concatenate([np.asarray(gj.t),
                               np.asarray([gj.yaw, gj.pitch, gj.roll])])
        np.testing.assert_allclose(float(loss[i]), float(val), rtol=1e-5)
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-6)

        (jp, jst), jl = jstep((p, joptim.init_adam_plateau(p, 0.1)), None)
        np.testing.assert_allclose(float(step_loss[i]), float(jl), rtol=1e-5)
        mine = [stepped[k][i].numpy() for k in range(16)]
        for k, (a, b) in enumerate(zip(mine[0:4], jp)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6,
                                       err_msg=f"pose leaf {k}")
        for k, (a, b) in enumerate(zip(mine[4:8], jst.m)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-7, err_msg=f"m leaf {k}")
        for k, (a, b) in enumerate(zip(mine[8:12], jst.v)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5,
                                       atol=1e-12, err_msg=f"v leaf {k}")
        assert int(mine[12]) == int(jst.count)
        assert float(mine[13]) == float(jst.lr)
        np.testing.assert_allclose(float(mine[14]), float(jst.best),
                                   rtol=1e-5)
        assert int(mine[15]) == int(jst.num_bad)
