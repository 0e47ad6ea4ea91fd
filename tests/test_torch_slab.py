"""The port's stage-1 slab plans and scorer against the JAX package.

  * Plan layout: the port's layout function, fed the JAX package's own
    projected (row, wx1, wy1), reproduces ``_plan_group`` bit for bit
    (fields, windows and block count).  Raw xyz cannot be compared this
    way: atan2 differs in the last bit between the two CPUs, which can
    flip a floor at a pixel boundary.
  * Plain scorer vs the JAX kernel (Pallas interpret mode) on a JAX-built
    plan carried across by ``convert``: counts exact, sums rtol 1e-6 (f32
    accumulation order).
  * End to end: scores rtol 1e-5 against JAX and the port's gather engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu.kernels import slab_sampling as jslab
from piccolo_tpu.init.refine import score_pose_grid as jscore_pose_grid
from piccolo_tpu.testing import make_room, render_at
from piccolo_tpu_torch.convert import grid_plan_from_numpy
from piccolo_tpu_torch.init.refine import score_pose_grid
from piccolo_tpu_torch.kernels import slab_sampling as tslab

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    xyz, rgb = make_room(rng, n_per_wall=128, size=(4.0, 3.0, 2.5))
    n, m = xyz.shape[0], 1024
    xyz_p = np.concatenate([xyz, rng.normal(size=(m - n, 3)).astype(np.float32)])
    rgb_p = np.concatenate([rgb, rng.random((m - n, 3)).astype(np.float32)])
    mask = np.arange(m) < n
    img = np.asarray(render_at(xyz, rgb, np.zeros(3, np.float32),
                               np.array([0.4, 0.1, 0.0], np.float32), (32, 64)))
    trans = rng.uniform(-1.0, 1.0, (4, 3)).astype(np.float32)
    rot = np.stack([np.linspace(0, 2 * np.pi, 8, endpoint=False),
                    np.zeros(8), np.zeros(8)], 1).astype(np.float32)
    return dict(xyz=xyz_p, rgb=rgb_p, mask=mask, img=img, trans=trans, rot=rot)


def _jax_group_pairs(s):
    pt, pr = jslab.make_pairs(jnp.asarray(s["trans"]), jnp.asarray(s["rot"]))
    pad = (-pt.shape[0]) % jslab.GROUP
    pt = jnp.concatenate([pt, jnp.broadcast_to(pt[:1], (pad, 3))])
    pr = jnp.concatenate([pr, jnp.broadcast_to(pr[:1], (pad, 3))])
    return pt, pr


def _jax_plan(s, **kw):
    return jslab.build_grid_plan(
        jnp.asarray(s["xyz"]), jnp.asarray(s["rgb"]), jnp.asarray(s["mask"]),
        jnp.asarray(s["trans"]), jnp.asarray(s["rot"]), 32, 64, **kw)


def _carried(jplan):
    return grid_plan_from_numpy(
        [np.asarray(f) for f in jplan.fields],
        [np.asarray(w) for w in jplan.windows], jplan.n_pairs, jplan.height,
        jplan.width, jplan.wrap, jplan.window, jplan.block, device="cpu")


@pytest.mark.parametrize("window,block", [(128, 1024), (256, 512)])
def test_plan_layout_bit_exact(scene, window, block):
    s = scene
    pt, pr = _jax_group_pairs(s)
    xyz, rgb, mask = (jnp.asarray(s[k]) for k in ("xyz", "rgb", "mask"))
    # jitted like inside _plan_group: XLA's fusion there rounds the
    # fractions differently from an eager call
    row, wx1, wy1 = jax.jit(jslab._project_group, static_argnums=(4, 5))(
        xyz, mask, pt, pr, 32, 64)
    sizes = jslab._plan_sizes(xyz, mask, pt[None], pr[None], height=32,
                              width=64, window=window, block=block)
    nb = jslab._nb_bucket(int(np.max(np.asarray(sizes))))
    want_f, want_w, _ = jslab._plan_group(
        xyz, rgb, mask, pt, pr, height=32, width=64, nb=nb, window=window,
        block=block)

    n_win = tslab._rpad(32, 64, window) // window
    trow = torch.tensor(np.asarray(row))
    assert tslab._nb_bucket(tslab._blocks_needed(trow, n_win, window, block)) == nb
    got_f, got_w = tslab._layout_group(
        trow, torch.tensor(np.asarray(wx1)), torch.tensor(np.asarray(wy1)),
        torch.tensor(s["rgb"]), nb=nb, n_win=n_win, window=window, block=block)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


@pytest.mark.parametrize("refresh", [False, True])
def test_plain_scorer_matches_jax_kernel_on_carried_plan(scene, refresh):
    s = scene
    jplan = _jax_plan(s)
    plan = _carried(jplan)
    img = jnp.asarray(s["img"])
    rgb2 = np.random.default_rng(11).random(s["rgb"].shape).astype(np.float32)
    tables = jslab._slab_tables(img, 32, 64, window=jplan.window)
    table = tslab.slab_table(torch.tensor(s["img"]), window=plan.window)
    for jf, jw, f, w in zip(jplan.fields, jplan.windows, plan.fields,
                            plan.windows):
        want_tot, want_cnt = jslab.slab_group_partials(
            tables, jf, jw, False, jnp.asarray(rgb2) if refresh else None,
            window=jplan.window)
        tot, cnt = tslab.slab_group_partials(
            table, f, w, plan.window, torch.tensor(rgb2) if refresh else None)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
        np.testing.assert_allclose(tot.numpy(), np.asarray(want_tot),
                                   rtol=1e-6, atol=1e-6)
    assert tslab.slab_block_partials.launches == 0  # CPU: plain version


@pytest.mark.parametrize("wrap", [False, True])
def test_slab_pair_scores_end_to_end(scene, wrap):
    s = scene
    plan = tslab.build_grid_plan(s["xyz"], s["rgb"], s["mask"], s["trans"],
                                 s["rot"], 32, 64, wrap=wrap, device="cpu")
    jplan = _jax_plan(s, wrap=wrap)
    assert (plan.window, plan.block, plan.n_pairs) == (
        jplan.window, jplan.block, jplan.n_pairs)
    assert [f.shape for f in plan.fields] == [f.shape for f in jplan.fields]
    img = torch.tensor(s["img"])
    got = tslab.slab_pair_scores(img, plan).numpy()
    want = np.asarray(jslab.slab_pair_scores(jnp.asarray(s["img"]), jplan))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    gather = score_pose_grid(img, torch.tensor(s["xyz"]), torch.tensor(s["rgb"]),
                             torch.tensor(s["trans"]), torch.tensor(s["rot"]),
                             torch.tensor(s["mask"]), wrap=wrap).numpy()
    np.testing.assert_allclose(got, gather, rtol=1e-5, atol=1e-6)


def test_rgb_refresh_end_to_end(scene):
    """A per-query colour rebind re-bakes the targets: scores match the
    gather engine and JAX under the new colours."""
    s = scene
    plan = tslab.build_grid_plan(s["xyz"], s["rgb"], s["mask"], s["trans"],
                                 s["rot"], 32, 64, device="cpu")
    rgb2 = np.random.default_rng(12).random(s["rgb"].shape).astype(np.float32)
    img = torch.tensor(s["img"])
    got = tslab.slab_pair_scores(img, plan, torch.tensor(rgb2)).numpy()
    want = np.asarray(jscore_pose_grid(
        jnp.asarray(s["img"]), jnp.asarray(s["xyz"]), jnp.asarray(rgb2),
        jnp.asarray(s["trans"]), jnp.asarray(s["rot"]), jnp.asarray(s["mask"])))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(compact=True), dict(quant=True)])
def test_unported_layouts_raise(scene, kw):
    s = scene
    with pytest.raises(NotImplementedError, match="later slice"):
        tslab.build_grid_plan(s["xyz"], s["rgb"], s["mask"], s["trans"],
                              s["rot"], 32, 64, device="cpu", **kw)


def test_plan_bytes_budget_and_stale_shape(scene):
    s = scene
    with pytest.raises(tslab.PlanOverBudget):
        tslab.build_grid_plan(s["xyz"], s["rgb"], s["mask"], s["trans"],
                              s["rot"], 32, 64, bytes_cap=1024, device="cpu")
    plan = tslab.build_grid_plan(s["xyz"], s["rgb"], s["mask"], s["trans"],
                                 s["rot"], 32, 64, bytes_cap=10**9, device="cpu")
    assert tslab.plan_exact_bytes(len(plan.fields), plan.fields[0].shape[0],
                                  plan.block) == plan.nbytes
    assert tslab.default_plan_bytes_cap("cpu") == tslab.DEFAULT_PLAN_BYTES_CAP
    with pytest.raises(ValueError, match="stale plan"):
        tslab.slab_pair_scores(torch.zeros(64, 128, 3), plan)
    assert tslab.resolve_plan_geometry(65536, 256, 512) == \
        jslab.resolve_plan_geometry(65536, 256, 512)
    assert tslab.resolve_plan_geometry(65536, 1024, 2048) == \
        jslab.resolve_plan_geometry(65536, 1024, 2048)
