"""The one-program room probe (``piccolo_tpu_torch.probe``) against the JAX
package's ``piccolo_tpu.probe``, on the CPU.

  * ``build_probe_state`` over three resident rooms of different sizes
    gives JAX's padded, subsampled stacks bit for bit (numpy on both
    sides).
  * ``probe_rooms`` on those stacks: the same room order, and losses within
    1e-4 at lr 0.01 and 20 iterations (the two packages' truncated loss
    tables pick the same starts; the short descents then differ by f32
    summation order only).  At the serving defaults (lr 0.1, 30
    iterations) the ranking still agrees.
  * A stack of one cloud ((1, N, 3), poses (1, S)) gives the loss and the
    gradients of the single cloud ((N, 3), poses (S,)) bit for bit, and so
    does a stack of one table through ``row_offset``.
"""

import numpy as np
import pytest
import torch

from piccolo_tpu_torch.loss import Pose, sampling_loss_packed
from piccolo_tpu_torch.ops.sampling import pack_bilinear_blocks
from piccolo_tpu_torch.probe import build_probe_state, probe_rooms
from piccolo_tpu_torch.serve import LocalizeService
from piccolo_tpu_torch.testing import make_room, render_at

torch.set_num_threads(1)

_CFG = dict(
    xy_only=True, num_trans=16, yaw_only=True, num_yaw=4, z_prior=None,
    num_split_h=4, num_split_w=4, num_intermediate=8, num_input=4,
    num_iter=20, lr=0.01, patience=5, factor=0.8,
)
_FIELDS = ("xyz", "rgb", "point_mask", "trans", "trans_valid", "rot", "lo",
           "hi")


@pytest.fixture(scope="module")
def rooms():
    """Three rooms of different sizes and a query of the second."""
    a = make_room(np.random.default_rng(17), n_per_wall=900, texture="plain")
    b = make_room(np.random.default_rng(5), n_per_wall=1500,
                  texture="checker")
    c = make_room(np.random.default_rng(9), n_per_wall=1200,
                  size=(5.0, 5.0, 2.8), texture="gradient")
    img = render_at(*b, np.float32([0.4, -0.2, 0.15]),
                    np.float32([0.9, 0.0, 0.0]), (64, 128),
                    device="cpu").numpy()
    return (("plain", a), ("checker", b), ("gradient", c)), img


def _states(rooms, max_pairs):
    from piccolo_tpu.probe import build_probe_state as jax_build
    from piccolo_tpu.serve import LocalizeService as JaxService

    out = []
    for svc, build in ((LocalizeService(max_rooms=3, device="cpu", **_CFG),
                        lambda *a, **kw: build_probe_state(*a, device="cpu",
                                                           **kw)),
                       (JaxService(max_rooms=3, **_CFG), jax_build)):
        for name, (xyz, rgb) in rooms:
            svc.load_room(xyz, rgb, name=name)
        resident = [(n, r[0]) for n, r in svc._rooms.items()]
        out.append(build(resident, _np(resident[0][1]["grids"].rot),
                         max_pairs=max_pairs))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("max_pairs", [512, 24])
def test_build_probe_state_equals_jax(rooms, max_pairs):
    got, want = _states(rooms[0], max_pairs)
    assert got.names == want.names == ("plain", "checker", "gradient")
    for f in _FIELDS:
        a, b = _np(getattr(got, f)), _np(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.trans.shape[1] % 8 == 0


@pytest.mark.parametrize("kw,atol", [
    (dict(num_starts=4, num_iter=20, lr=0.01, patience=5, factor=0.8), 1e-4),
    (dict(num_starts=6, num_iter=30, lr=0.1, patience=5, factor=0.8), None),
])
def test_probe_rooms_matches_jax(rooms, kw, atol):
    import jax.numpy as jnp

    from piccolo_tpu.probe import probe_rooms as jax_probe

    (got_st, want_st), img = _states(rooms[0], 512), rooms[1]
    got = got_st.losses(img, **kw)
    want = np.asarray(jax_probe(jnp.asarray(img), *(
        getattr(want_st, f) for f in _FIELDS), **kw))
    assert got.shape == want.shape == (3,) and np.isfinite(got).all()
    assert np.argsort(got).tolist() == np.argsort(want).tolist()
    assert int(np.argmin(got)) == 1  # the query's own room
    if atol is not None:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the eager loop is the CPU path: the private switch changes nothing
    np.testing.assert_array_equal(got, probe_rooms(
        img, *(getattr(got_st, f) for f in _FIELDS), device="cpu",
        _eager=True, **kw).numpy())


def test_stack_of_one_equals_single(rooms):
    (_, (xyz, rgb)), img = rooms[0][1], rooms[1]
    xyz, rgb = torch.tensor(xyz), torch.tensor(rgb)
    mask = torch.arange(xyz.shape[0]) % 7 != 0
    blocks = pack_bilinear_blocks(torch.tensor(img))
    rng = np.random.default_rng(3)
    t0 = torch.tensor(rng.uniform(-0.5, 0.5, (4, 3)), dtype=torch.float32)
    y0 = torch.tensor(rng.uniform(-3, 3, (4, 3)), dtype=torch.float32)

    def loss_and_grads(lead, stack, row_offset=None):
        leaves = [t0.reshape(lead + (3,)).clone()] + [
            y0[:, i].reshape(lead).clone() for i in range(3)]
        for x in leaves:
            x.requires_grad_(True)
        loss = sampling_loss_packed(Pose(*leaves), stack(xyz), stack(rgb),
                                    blocks, 64, 128, stack(mask),
                                    row_offset=row_offset)
        grads = torch.autograd.grad(loss.sum(), leaves)
        return [loss.reshape(-1)] + [g.reshape(-1) for g in grads]

    want = loss_and_grads((4,), lambda x: x)
    for got in (loss_and_grads((1, 4), lambda x: x[None]),
                loss_and_grads((4,), lambda x: x,
                               torch.zeros((4, 1), dtype=torch.int32))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
