"""The port's mesh paths (``piccolo_tpu_torch.parallel``) against the JAX
package's on the CPU.

The JAX functions run on conftest's 8 virtual CPU devices; the port's mesh
puts every shard on the CPU (``devices=["cpu"] * 8``), the counterpart of
those devices.  The same numpy inputs (test_parallel.py's scenes: 4,800
points, a 64x128 image) go through both:

  * ``make_mesh`` factors like JAX's;
  * ``solve_sharded`` on every factorization of 8 under test_parallel.py's
    tolerances (3 iterations tight; at 30 the same winner, its pose within
    8e-2 and its loss within 8e-3: the descent amplifies the sums' order);
    padding points is inert; prune on the mesh;
  * ``localize_query_sharded`` at (2, 4) and (4, 2) on the gather engine
    and on f32 (with a sharded HistPlan), compact and q8 sharded plans: the
    same starts and winner as JAX's sharded query and as the port's
    single-device query, ``cand_t`` within 2e-3 and ``cand_loss`` within
    1e-3; the same with a colour rebind re-baked per shard, and with
    ``criterion="loss"``;
  * stage 2's z-buffer keys, combined over point shards by a minimum, equal
    the whole cloud's bit for bit from identical projected pixels;
  * ``shard_hist_plan``'s planes equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu import parallel as jpar
from piccolo_tpu.init import build_hist_plan as jbuild_hist_plan
from piccolo_tpu.init import default_init_dict
from piccolo_tpu.init.candidates import generate_rot_points, generate_trans_points
from piccolo_tpu.loss import Pose as JPose, transform_cloud as jtransform
from piccolo_tpu.ops import pano as jpano
from piccolo_tpu.ops.projection import spherical_project as jproject
from piccolo_tpu.ops.quantile import cloud_bounds
from piccolo_tpu.testing import make_room, render_at
from piccolo_tpu_torch import build_grid_plan, build_hist_plan, localize_query
from piccolo_tpu_torch import parallel as tpar
from piccolo_tpu_torch.ops import pano as tpano
from piccolo_tpu_torch.solver import descend

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]
LAYOUTS = {"f32": {}, "compact": dict(compact=True),
           "q8": dict(compact=True, quant=True)}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    xyz, rgb = make_room(rng, n_per_wall=800)
    gt_t = np.array([0.3, -0.2, 0.1], np.float32)
    gt_ypr = np.array([0.9, 0.0, 0.0], np.float32)
    img = np.asarray(render_at(xyz, rgb, gt_t, gt_ypr, (64, 128)))
    lo, hi = cloud_bounds(jnp.asarray(xyz), 0.05)
    t0 = np.stack([gt_t + [0.2, -0.1, 0.05], [1.0, 1.0, 0.3],
                   [-1.0, 0.5, 0.2]]).astype(np.float32)
    ypr0 = np.stack([[1.1, 0, 0], [2.0, 0, 0], [4.0, 0, 0]]).astype(np.float32)
    return dict(xyz=xyz, rgb=rgb, img=img, lo=np.asarray(lo),
                hi=np.asarray(hi), t0=t0, ypr0=ypr0, gt_t=gt_t)


@pytest.fixture(scope="module")
def fused_scene():
    rng = np.random.default_rng(5)
    xyz, rgb = make_room(rng, n_per_wall=800, texture="checker")
    gt_t = np.array([0.5, -0.4, 0.2], np.float32)
    gt_ypr = np.array([2.1, 0.0, 0.0], np.float32)
    img = np.asarray(render_at(xyz, rgb, gt_t, gt_ypr, (64, 128)))
    lo, hi = cloud_bounds(jnp.asarray(xyz), 0.05)
    d = default_init_dict(xy_only=True, num_trans=20, yaw_only=True,
                          num_yaw=8, num_split_h=4, num_split_w=4)
    trans = generate_trans_points(xyz, d)
    rot = generate_rot_points(d)
    n_real = trans.shape[0]
    pad = 5  # masked rows exercise the validity carrying
    valid = np.arange(n_real + pad) < n_real
    trans = np.concatenate([trans, np.zeros((pad, 3), np.float32)])
    return dict(xyz=xyz, rgb=rgb, img=img, lo=np.asarray(lo),
                hi=np.asarray(hi), trans=trans, rot=rot, valid=valid,
                n_real=n_real, gt_t=gt_t)


# test_parallel.py's settings at lr 0.01: at lr 0.1 this scene's descent
# amplifies the two frameworks' ulp differences past the tolerances
# (ROADMAP Queue 3), on one device as on the mesh
FUSED_KW = dict(num_intermediate=12, num_input=4, num_split_h=4,
                num_split_w=4, num_iter=5, lr=0.01, patience=5, factor=0.8,
                grid_chunk=8, hist_chunk=4)


@pytest.mark.parametrize("args", [dict(), dict(n_cand=4), dict(n_point=8),
                                  dict(n_cand=2, n_point=4)])
@pytest.mark.parametrize("n", [8, 6, 2])
def test_make_mesh_factors_like_jax(args, n):
    if n % args.get("n_cand", 1) or n % args.get("n_point", 1) or (
            len(args) == 2 and n != 8):
        for make, devs in ((jpar.make_mesh, jax.devices()[:n]),
                           (tpar.make_mesh, ["cpu"] * n)):
            with pytest.raises(AssertionError):
                make(devices=devs, **args)
        return
    want = jpar.make_mesh(devices=jax.devices()[:n], **args).shape
    got = tpar.make_mesh(devices=["cpu"] * n, **args)
    assert got.shape == dict(want)
    assert got.lead == torch.device("cpu")


def _solve_both(s, mesh_shape, **kw):
    jmesh = jpar.make_mesh(*mesh_shape)
    tmesh = tpar.make_mesh(*mesh_shape, devices=CPU8)
    args = (s["img"], s["xyz"], s["rgb"], s["t0"], s["ypr0"], s["lo"],
            s["hi"])
    return (jpar.solve_sharded(jmesh, *args, **kw)[3],
            tpar.solve_sharded(tmesh, *args, **kw)[3])


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_solve_sharded_matches_jax(scene, mesh_shape):
    """test_parallel.py's tolerances: 3 iterations tight; at 30 the winner
    and its basin (non-converging candidates carry the sums' order)."""
    s = scene
    kw = dict(lr=0.1, patience=5, factor=0.8)
    j3, t3 = _solve_both(s, mesh_shape, num_iter=3, **kw)
    np.testing.assert_allclose(t3.t.numpy(), np.asarray(j3.t), atol=2e-2)
    np.testing.assert_allclose(t3.loss.numpy(), np.asarray(j3.loss),
                               atol=1e-3)
    j30, t30 = _solve_both(s, mesh_shape, num_iter=30, **kw)
    k, kj = int(torch.argmin(t30.loss)), int(np.argmin(np.asarray(j30.loss)))
    assert k == kj
    np.testing.assert_allclose(t30.t[k].numpy(), np.asarray(j30.t[kj]),
                               atol=8e-2)
    assert abs(float(t30.loss[k]) - float(j30.loss[kj])) < 8e-3
    # and against the port's own single-device descent
    one = descend(s["img"], s["xyz"], s["rgb"], s["t0"], s["ypr0"], s["lo"],
                  s["hi"], num_iter=3, device="cpu", **kw)
    np.testing.assert_allclose(t3.t.numpy(), one.t.numpy(), atol=1e-5)


def test_sharded_point_padding_is_inert(scene):
    """A cloud whose size the point axis does not divide gives the results
    of the same cloud masked down to that size."""
    s = scene
    mesh = tpar.make_mesh(2, 4, devices=CPU8)
    m = s["xyz"].shape[0] - 3
    kw = dict(num_iter=10, factor=0.8)
    t1, _, l1, _ = tpar.solve_sharded(mesh, s["img"], s["xyz"][:m],
                                      s["rgb"][:m], s["t0"], s["ypr0"],
                                      s["lo"], s["hi"], **kw)
    t2, _, l2, _ = tpar.solve_sharded(
        mesh, s["img"], s["xyz"], s["rgb"], s["t0"], s["ypr0"], s["lo"],
        s["hi"], point_mask=np.arange(s["xyz"].shape[0]) < m, **kw)
    np.testing.assert_allclose(t1.numpy(), t2.numpy(), atol=1e-5)
    assert abs(float(l1) - float(l2)) < 1e-6


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2)])
def test_sharded_prune_matches_jax(scene, mesh_shape):
    """Prune (8, 2) of 24 over the mesh: the winner, the survivors'
    losses and the frozen pruned rows as in JAX's sharded prune, under
    test_parallel.py's tolerances."""
    s = scene
    kw = dict(num_iter=24, lr=0.1, patience=5, factor=0.8, prune=(8, 2))
    jres, tres = _solve_both(s, mesh_shape, **kw)
    assert int(torch.argmin(tres.loss)) == int(np.argmin(np.asarray(jres.loss)))
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=8e-2)
    np.testing.assert_allclose(tres.loss.numpy(), np.asarray(jres.loss),
                               atol=3e-2)
    one = descend(s["img"], s["xyz"], s["rgb"], s["t0"], s["ypr0"], s["lo"],
                  s["hi"], device="cpu", **kw)
    k = int(torch.argmin(one.loss))
    assert int(torch.argmin(tres.loss)) == k
    assert abs(float(tres.loss[k]) - float(one.loss[k])) < 8e-3


def _memo(f, key, make):
    """``make()`` once per scene and key (the scene dict holds the memo)."""
    memo = f.setdefault("memo", {})
    if key not in memo:
        memo[key] = make()
    return memo[key]


def _jax_plans(f, route, mesh):
    if route == "gather":
        return {}
    t = jnp.asarray(f["trans"][:f["n_real"]])
    plan = jpar.shard_grid_plan(mesh, f["xyz"], f["rgb"], None, t,
                                jnp.asarray(f["rot"]), 64, 128,
                                **LAYOUTS[route])
    out = dict(plan=plan)
    if route == "f32":
        hp = _memo(f, "jax hist plan", lambda: jbuild_hist_plan(
            jnp.asarray(f["xyz"]), jnp.asarray(f["rgb"]), t,
            jnp.asarray(f["rot"]), 64, 128))
        out["hist_plan"] = jpar.shard_hist_plan(mesh, hp)
    return out


def _port_plans(f, route, mesh=None):
    if route == "gather":
        return {}
    t = f["trans"][:f["n_real"]]
    if mesh is None:
        out = dict(plan=_memo(f, route, lambda: build_grid_plan(
            f["xyz"], f["rgb"], None, t, f["rot"], 64, 128, device="cpu",
            **LAYOUTS[route])))
    else:
        out = dict(plan=tpar.shard_grid_plan(mesh, f["xyz"], f["rgb"], None, t,
                                             f["rot"], 64, 128,
                                             **LAYOUTS[route]))
    if route == "f32":
        hp = _memo(f, "hist plan", lambda: build_hist_plan(
            f["xyz"], f["rgb"], t, f["rot"], 64, 128, device="cpu"))
        out["hist_plan"] = hp if mesh is None else tpar.shard_hist_plan(mesh,
                                                                        hp)
    return out


def _fused_args(f):
    return (f["img"], f["img"], f["xyz"], f["rgb"], f["trans"], f["rot"],
            f["valid"], f["lo"], f["hi"])


def _assert_same_query(got, want, exact_starts=True):
    if exact_starts:
        np.testing.assert_array_equal(got.start_t.numpy(),
                                      np.asarray(want.start_t))
        np.testing.assert_array_equal(got.start_ypr.numpy(),
                                      np.asarray(want.start_ypr))
    assert int(got.winner) == int(want.winner)
    np.testing.assert_allclose(got.cand_t.numpy(), np.asarray(want.cand_t),
                               atol=2e-3)
    np.testing.assert_allclose(got.cand_loss.numpy(),
                               np.asarray(want.cand_loss), atol=1e-3)


@pytest.mark.parametrize("route", ["gather", "f32", "compact", "q8"])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
def test_localize_query_sharded_matches_jax(fused_scene, mesh_shape, route):
    """Stage 1 on the gather engine or a sharded plan (f32 with a sharded
    HistPlan for stage 2, else the live splat): the same starts and winner
    as JAX's sharded query and as the port's single-device query."""
    f = fused_scene
    jmesh = jpar.make_mesh(*mesh_shape)
    tmesh = tpar.make_mesh(*mesh_shape, devices=CPU8)
    want = jpar.localize_query_sharded(jmesh, *_fused_args(f), **FUSED_KW,
                                       **_jax_plans(f, route, jmesh))
    got = tpar.localize_query_sharded(tmesh, *_fused_args(f), **FUSED_KW,
                                      **_port_plans(f, route, tmesh))
    _assert_same_query(got, want)
    one = _memo(f, ("single", route), lambda: localize_query(
        *_fused_args(f), device="cpu", **FUSED_KW, **_port_plans(f, route)))
    _assert_same_query(got, one)


def test_sharded_plan_refresh_matches_jax(fused_scene):
    """A per-query colour rebind: each shard re-bakes its plan's targets
    from its own slice of the new colours."""
    f = fused_scene
    rgb2 = np.clip(f["rgb"] * 0.85 + 0.05, 0.0, 1.0).astype(np.float32)
    args = list(_fused_args(f))
    args[3] = rgb2
    kw = dict(FUSED_KW, num_iter=3, plan_refresh_rgb=True)
    jmesh = jpar.make_mesh(2, 4)
    tmesh = tpar.make_mesh(2, 4, devices=CPU8)
    t = f["trans"][:f["n_real"]]
    jplan = jpar.shard_grid_plan(jmesh, f["xyz"], f["rgb"], None,
                                 jnp.asarray(t), jnp.asarray(f["rot"]), 64,
                                 128)
    want = jpar.localize_query_sharded(jmesh, *args, plan=jplan, **kw)
    tplan = tpar.shard_grid_plan(tmesh, f["xyz"], f["rgb"], None, t, f["rot"],
                                 64, 128)
    got = tpar.localize_query_sharded(tmesh, *args, plan=tplan, **kw)
    _assert_same_query(got, want)
    one = localize_query(*args, device="cpu", **kw,
                         plan=_port_plans(f, "f32")["plan"])
    _assert_same_query(got, one)
    # a rebind of a pre-sharded cloud's colours gives the same query
    cloud = tpar.shard_cloud(tmesh, f["xyz"], f["rgb"])
    again = tpar.localize_query_sharded(tmesh, args[0], args[1], cloud, rgb2,
                                        *args[4:], plan=tplan, **kw)
    assert torch.equal(again.cand_t, got.cand_t)


def test_sharded_criterion_loss_matches_jax(fused_scene):
    """criterion='loss' (no stage 2): the starts are the top 4 by stage-1
    loss, the same set as JAX's sharded query, the same winner pose."""
    f = fused_scene
    kw = dict(FUSED_KW, criterion="loss")
    want = jpar.localize_query_sharded(jpar.make_mesh(2, 4), *_fused_args(f),
                                       **kw)
    got = tpar.localize_query_sharded(tpar.make_mesh(2, 4, devices=CPU8),
                                      *_fused_args(f), **kw)
    one = localize_query(*_fused_args(f), device="cpu", **kw)
    for ref in (want, one):
        assert ({tuple(r) for r in got.start_t.numpy().round(5)}
                == {tuple(r) for r in np.asarray(ref.start_t).round(5)})
        np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t),
                                   atol=2e-3)
        assert abs(float(got.loss) - float(ref.loss)) < 1e-3


def test_sharded_fused_prune_matches_single_device(scene):
    """descent_prune through the sharded query equals the single-device
    query and JAX's sharded query with the same prune (test_parallel.py's
    scene and tolerances)."""
    s = scene
    trans = np.concatenate([s["t0"], np.zeros((1, 3), np.float32)])
    rots = np.asarray([[0.9, 0, 0], [2.4, 0, 0]], np.float32)
    valid = np.array([True, True, True, False])
    # lr 0.01: at lr 0.1 the third start's final loss moves 0.044-0.055
    # with ulp noise, across the winner's, in either framework
    kw = dict(num_intermediate=4, num_input=3, num_iter=24, lr=0.01,
              patience=5, factor=0.8, descent_prune=(8, 2))
    args = (s["img"], s["img"], s["xyz"], s["rgb"], trans, rots, valid,
            s["lo"], s["hi"])
    one = localize_query(*args, device="cpu", **kw)
    got = tpar.localize_query_sharded(tpar.make_mesh(2, 4, devices=CPU8),
                                      *args, **kw)
    want = jpar.localize_query_sharded(jpar.make_mesh(2, 4), *args, **kw)
    for ref in (one, want):
        assert int(got.winner) == int(ref.winner)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t),
                                   atol=8e-2)
        assert abs(float(got.loss) - float(ref.loss)) < 8e-3
        np.testing.assert_array_equal(got.start_t.numpy(),
                                      np.asarray(ref.start_t))


@pytest.mark.parametrize("n_point", [2, 4, 8])
def test_stage2_keys_combine_bit_exact(fused_scene, n_point):
    """The minimum of the point shards' packed z-buffer keys is the whole
    cloud's splat, bit for bit, from identical projected pixels (JAX's
    projection lines; the two frameworks' atan2 differ in the last bit)."""
    f = fused_scene
    H, W = 32, 64
    xyz, n = f["xyz"], f["xyz"].shape[0]
    attr = np.random.default_rng(6).integers(0, 513, n).astype(np.int32)
    mask = np.arange(n) % 13 != 0
    per = -(-n // n_point)
    for i in (0, 7, 20):
        p = JPose(t=jnp.asarray(f["trans"][i]), yaw=jnp.asarray(f["rot"][i % 8, 0]),
                  pitch=jnp.asarray(0.0), roll=jnp.asarray(0.0))
        cam = jtransform(p, jnp.asarray(xyz))
        want = np.asarray(jpano.attr_min_keys(cam, jnp.asarray(attr), 10,
                                              (H, W), jnp.asarray(mask)))
        dist = np.asarray(jnp.sqrt(jnp.sum(cam * cam, axis=-1)))
        coords = jproject(cam)
        col0 = np.asarray(jnp.floor((coords[..., 0] + 1.0) / 2.0 * (W - 1)))
        row0 = np.asarray(jnp.floor((coords[..., 1] + 1.0) / 2.0 * (H - 1)))
        keys = None
        for s in range(n_point):
            sl = slice(s * per, (s + 1) * per)
            k = tpano.attr_min_keys_from_pixels(
                torch.tensor(dist[sl])[None], torch.tensor(row0[sl]).long()[None],
                torch.tensor(col0[sl]).long()[None], torch.tensor(attr[sl]),
                10, (H, W), torch.tensor(mask[sl]))[0]
            keys = k if keys is None else torch.minimum(keys, k)
        np.testing.assert_array_equal(keys.numpy(), want)


@pytest.mark.parametrize("n_cand", [2, 3, 8])
def test_shard_hist_plan_planes_match_jax(fused_scene, n_cand):
    f = fused_scene
    t = f["trans"][:f["n_real"]]
    jplan = jbuild_hist_plan(jnp.asarray(f["xyz"]), jnp.asarray(f["rgb"]),
                             jnp.asarray(t), jnp.asarray(f["rot"]), 32, 64)
    n_point = 8 // n_cand
    want = np.asarray(jpar.shard_hist_plan(
        jpar.make_mesh(n_cand, n_point,
                       devices=jax.devices()[:n_cand * n_point]),
        jplan).planes)
    plan = build_hist_plan(f["xyz"], f["rgb"], t, f["rot"], 32, 64,
                           device="cpu")
    sharded = tpar.shard_hist_plan(
        tpar.make_mesh(n_cand, n_point, devices=["cpu"] * (n_cand * n_point)),
        plan)
    got = torch.cat(sharded.planes).numpy()
    np.testing.assert_array_equal(got, want[:got.shape[0]])
    assert sharded.nbytes == plan.nbytes


def test_sharded_plan_budget_counts_each_card(fused_scene):
    """A mesh that repeats a device holds all of its shards there: the
    sharded plan's budget adds them up, and refuses what one card cannot
    hold."""
    from piccolo_tpu_torch.kernels.slab_sampling import PlanOverBudget

    f = fused_scene
    t = f["trans"][:f["n_real"]]
    mesh = tpar.make_mesh(2, 4, devices=CPU8)
    plan = tpar.shard_grid_plan(mesh, f["xyz"], f["rgb"], None, t, f["rot"],
                                64, 128)
    with pytest.raises(PlanOverBudget):
        tpar.shard_grid_plan(mesh, f["xyz"], f["rgb"], None, t, f["rot"], 64,
                             128, bytes_cap=plan.nbytes - 1)
    again = tpar.shard_grid_plan(mesh, f["xyz"], f["rgb"], None, t, f["rot"],
                                 64, 128, bytes_cap=plan.nbytes)
    assert again.nbytes == plan.nbytes
