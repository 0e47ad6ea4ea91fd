"""The port's Adam + ReduceLROnPlateau against the JAX package's.

A fixed sequence of gradients and losses (numpy, from a seed) drives three
starts for 60 steps with plateau drops.  Parameters agree within rtol 1e-6
(the bias-correction powers come from two libraries' pow); the learning
rate, plateau counter, best loss and step count agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu import loss as jloss
from piccolo_tpu import optim as joptim
from piccolo_tpu_torch import loss as tloss
from piccolo_tpu_torch import optim as toptim

torch.set_num_threads(2)

S, STEPS = 3, 60


def _inputs(seed):
    rng = np.random.default_rng(seed)
    grads = rng.normal(size=(STEPS, S, 6)).astype(np.float32)
    grads[:, :, 3:] *= 0.1
    # per start: improving, then flat stretches that trip the plateau rule
    loss = np.empty((STEPS, S), np.float32)
    for s in range(S):
        cur = 1.0 + s
        for i in range(STEPS):
            if (i // (8 + 3 * s)) % 2 == 0:
                cur *= 0.97
            loss[i, s] = cur
    p0 = rng.normal(size=(S, 6)).astype(np.float32)
    return p0, grads, loss


def _tpose(x):
    x = torch.tensor(x)
    return tloss.Pose(x[:, :3], x[:, 3], x[:, 4], x[:, 5])


def _jpose(x):
    return jloss.Pose(jnp.asarray(x[:3]), jnp.asarray(x[3]), jnp.asarray(x[4]),
                      jnp.asarray(x[5]))


@pytest.mark.parametrize("patience,factor", [(5, 0.8), (2, 0.5)])
def test_adam_plateau_matches_jax(patience, factor):
    p0, grads, loss = _inputs(patience)
    params = _tpose(p0)
    state = toptim.init_adam_plateau(params, 0.1)
    for i in range(STEPS):
        params, state = toptim.adam_plateau_step(
            params, _tpose(grads[i]), state, torch.tensor(loss[i]), patience,
            factor)
    got = torch.cat([params.t, torch.stack(
        [params.yaw, params.pitch, params.roll], -1)], -1).numpy()
    drops = 0
    for s in range(S):
        jp = _jpose(p0[s])
        js = joptim.init_adam_plateau(jp, 0.1)
        for i in range(STEPS):
            jp, js = joptim.adam_plateau_step(
                jp, _jpose(grads[i, s]), js, jnp.asarray(loss[i, s]),
                patience, factor)
        want = np.concatenate([np.asarray(jp.t), np.asarray(
            [jp.yaw, jp.pitch, jp.roll])])
        np.testing.assert_allclose(got[s], want, rtol=1e-6, atol=1e-7)
        assert state.lr[s].item() == float(js.lr)
        assert state.num_bad[s].item() == int(js.num_bad)
        assert state.count[s].item() == int(js.count)
        assert state.best[s].item() == float(js.best)
        drops += float(js.lr) < 0.1
    assert drops == S  # every start saw at least one plateau drop
