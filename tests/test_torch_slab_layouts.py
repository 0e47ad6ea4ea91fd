"""The port's compact and q8 slab plans and scorers against the JAX package.

  * Streams: the port's layout function, fed the JAX package's own
    projected (row, wx1, wy1), reproduces ``_plan_group``'s compact and q8
    streams bit for bit (fields, tps and windows), with targets and with
    point ids, in both plan geometries.
  * Plain scorers vs the JAX kernels (Pallas interpret mode) on a JAX-built
    plan carried across by ``convert``, with and without a per-query rgb
    re-bake: counts exact, sums rtol 1e-5.
  * ``slab_pair_scores`` end to end on port-built plans against JAX.
  * The q8 pad's int32 bit pattern, and the layout errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu.kernels import slab_sampling as jslab
from piccolo_tpu.testing import make_room, render_at
from piccolo_tpu_torch.convert import grid_plan_from_numpy
from piccolo_tpu_torch.kernels import slab_sampling as tslab

torch.set_num_threads(2)

LAYOUTS = {"compact": dict(compact=True), "q8": dict(compact=True, quant=True)}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    xyz, rgb = make_room(rng, n_per_wall=128, size=(4.0, 3.0, 2.5))
    n, m = xyz.shape[0], 1024
    xyz_p = np.concatenate([xyz, rng.normal(size=(m - n, 3)).astype(np.float32)])
    # loader-like colours (i/255), as the compact targets assume
    rgb_p = np.concatenate([rgb, rng.random((m - n, 3)).astype(np.float32)])
    rgb_p = (np.round(rgb_p * 255) / 255).astype(np.float32)
    mask = np.arange(m) < n
    img = np.asarray(render_at(xyz, rgb, np.zeros(3, np.float32),
                               np.array([0.4, 0.1, 0.0], np.float32), (32, 64)))
    trans = rng.uniform(-1.0, 1.0, (4, 3)).astype(np.float32)
    rot = np.stack([np.linspace(0, 2 * np.pi, 8, endpoint=False),
                    np.zeros(8), np.zeros(8)], 1).astype(np.float32)
    rgb2 = (np.round(rng.random(rgb_p.shape) * 255) / 255).astype(np.float32)
    return dict(xyz=xyz_p, rgb=rgb_p, mask=mask, img=img, trans=trans,
                rot=rot, rgb2=rgb2)


def _jax_plan(s, **kw):
    return jslab.build_grid_plan(
        jnp.asarray(s["xyz"]), jnp.asarray(s["rgb"]), jnp.asarray(s["mask"]),
        jnp.asarray(s["trans"]), jnp.asarray(s["rot"]), 32, 64, **kw)


def _carried(jp):
    return grid_plan_from_numpy(
        [np.asarray(f) for f in jp.fields], [np.asarray(w) for w in jp.windows],
        jp.n_pairs, jp.height, jp.width, jp.wrap, jp.window, jp.block,
        tps=[np.asarray(t) for t in jp.tps], compact=jp.compact,
        tp_is_pid=jp.tp_is_pid, quant=jp.quant, device="cpu")


@pytest.mark.parametrize("window,block", [(128, 1024), (256, 512)])
@pytest.mark.parametrize("tp_is_pid", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_streams_bit_exact(scene, layout, tp_is_pid, window, block):
    s = scene
    kw = LAYOUTS[layout]
    pt, pr = jslab.make_pairs(jnp.asarray(s["trans"]), jnp.asarray(s["rot"]))
    pad = (-pt.shape[0]) % jslab.GROUP
    pt = jnp.concatenate([pt, jnp.broadcast_to(pt[:1], (pad, 3))])
    pr = jnp.concatenate([pr, jnp.broadcast_to(pr[:1], (pad, 3))])
    xyz, rgb, mask = (jnp.asarray(s[k]) for k in ("xyz", "rgb", "mask"))
    # jitted like inside _plan_group: XLA's fusion there rounds the
    # fractions differently from an eager call
    row, wx1, wy1 = jax.jit(jslab._project_group, static_argnums=(4, 5))(
        xyz, mask, pt, pr, 32, 64)
    sizes = jslab._plan_sizes(xyz, mask, pt[None], pr[None], height=32,
                              width=64, window=window, block=block)
    nb = jslab._nb_bucket(int(np.max(np.asarray(sizes))))
    want_f, want_w, want_t = jslab._plan_group(
        xyz, rgb, mask, pt, pr, height=32, width=64, nb=nb, window=window,
        block=block, tp_is_pid=tp_is_pid, **kw)

    n_win = tslab._rpad(32, 64, window) // window
    got_f, got_w, got_t = tslab._layout_group(
        torch.tensor(np.asarray(row)), torch.tensor(np.asarray(wx1)),
        torch.tensor(np.asarray(wy1)), torch.tensor(s["rgb"]), nb=nb,
        n_win=n_win, window=window, block=block, tp_is_pid=tp_is_pid, **kw)
    assert got_f.dtype == (torch.int32 if layout == "q8" else torch.float32)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_scorers_match_jax_kernels(scene, layout, refresh):
    s = scene
    jp = _jax_plan(s, tp_is_pid=refresh, **LAYOUTS[layout])
    plan = _carried(jp)
    tables = jslab._slab_tables(jnp.asarray(s["img"]), 32, 64,
                                window=jp.window)
    table = tslab.slab_table(torch.tensor(s["img"]), window=plan.window)
    jrgb = jnp.asarray(s["rgb2"]) if refresh else None
    trgb = torch.tensor(s["rgb2"]) if refresh else None
    for jf, jw, jt, f, w, t in zip(jp.fields, jp.windows, jp.tps, plan.fields,
                                   plan.windows, plan.tps):
        want_tot, want_cnt = jslab.slab_group_partials(
            tables, jf, jw, True, jrgb, tps=jt, window=jp.window,
            quant=jp.quant)
        tot, cnt = tslab.slab_group_partials(table, f, w, plan.window, trgb,
                                             t, plan.compact, plan.quant)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
        np.testing.assert_allclose(tot.numpy(), np.asarray(want_tot),
                                   rtol=1e-5, atol=1e-6)
    # CPU tensors: the plain versions ran, no kernel launched
    assert tslab.slab_group_sums_compact.launches == 0
    assert tslab.slab_group_sums_q8.launches == 0


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_slab_pair_scores_end_to_end(scene, layout, refresh):
    s = scene
    kw = dict(LAYOUTS[layout], tp_is_pid=refresh)
    plan = tslab.build_grid_plan(s["xyz"], s["rgb"], s["mask"], s["trans"],
                                 s["rot"], 32, 64, device="cpu", **kw)
    jp = _jax_plan(s, **kw)
    assert (plan.window, plan.block, plan.n_pairs, plan.compact, plan.quant) \
        == (jp.window, jp.block, jp.n_pairs, jp.compact, jp.quant)
    assert [f.shape for f in plan.fields] == [f.shape for f in jp.fields]
    assert plan.nbytes == jp.nbytes
    rgb = s["rgb2"] if refresh else None
    got = tslab.slab_pair_scores(
        torch.tensor(s["img"]), plan,
        None if rgb is None else torch.tensor(rgb)).numpy()
    want = np.asarray(jslab.slab_pair_scores(
        jnp.asarray(s["img"]), jp, None if rgb is None else jnp.asarray(rgb)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_q8_pad_sentinel_bit_pattern(scene):
    s = scene
    plan = tslab.build_grid_plan(s["xyz"], s["rgb"], s["mask"], s["trans"],
                                 s["rot"], 32, 64, compact=True, quant=True,
                                 device="cpu")
    jp = _jax_plan(s, compact=True, quant=True)
    pads = plan.tps[0] == 0  # only pad slots carry a zero target here
    f = plan.fields[0][pads]
    assert f.numel() > 0
    assert (f == -8388608).all()
    assert (f.view(torch.int32).numpy().view(np.uint32) == 0xFF800000).all()
    assert int(np.asarray(jp.fields[0])[np.asarray(jp.tps[0]) == 0][0]) \
        == -8388608
    assert ((f >> 23) & 0x1FF == 511).all()


def test_layout_errors(scene):
    s = scene
    args = (s["xyz"], s["rgb"], s["mask"], s["trans"], s["rot"], 32, 64)
    with pytest.raises(ValueError, match="sub-mode of compact"):
        tslab.build_grid_plan(*args, quant=True, device="cpu")
    with pytest.raises(ValueError, match="window <= 256"):
        tslab.build_grid_plan(*args, compact=True, quant=True, window=512,
                              block=1024, device="cpu")
    pid_plan = tslab.build_grid_plan(*args, compact=True, tp_is_pid=True,
                                     device="cpu")
    with pytest.raises(ValueError, match="refresh-capable"):
        tslab.slab_pair_scores(torch.tensor(s["img"]), pid_plan)
    tgt_plan = tslab.build_grid_plan(*args, compact=True, device="cpu")
    with pytest.raises(ValueError, match="tp_is_pid=True"):
        tslab.slab_pair_scores(torch.tensor(s["img"]), tgt_plan,
                               torch.tensor(s["rgb2"]))
    with pytest.raises(tslab.PlanOverBudget):
        tslab.build_grid_plan(*args, compact=True, quant=True, bytes_cap=1024,
                              device="cpu")
