"""The group-sum slab wrappers (f32, compact and q8 plans) and the plan
layout their kernel relies on, against the JAX package, on the CPU.

  * The plan invariant: in every block the real samples come first, so a
    block whose slot 0 is a pad holds no real sample.  The kernel skips such
    blocks after one probe.  Checked on plans built by the port and by the
    JAX package (carried across by ``convert``), in all three layouts and
    both plan geometries, full and partial (leading trans rows, tight block
    count), with point ids in ``tps`` (compact, q8).
  * ``slab_group_sums_{f32,compact,q8}`` on CPU tensors (their plain
    versions) against JAX's ``slab_group_partials`` (Pallas interpret
    mode), with and without a per-query rgb re-bake: counts exact, sums
    rtol 1e-5, atol 1e-6.
  * The fused re-bake's plain path (the colours and point ids) equals a
    re-bake by a separate gather (f32: into a copy of the group) bit for
    bit, and the hand-built edge plans of the card tests score as a float64
    per-sample reference does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu.kernels import slab_sampling as jslab
from piccolo_tpu.testing import make_room, render_at
from piccolo_tpu_torch.convert import grid_plan_from_numpy
from piccolo_tpu_torch.kernels import slab_sampling as tslab
from piccolo_tpu_torch.testing import edge_plan_group

torch.set_num_threads(1)

LAYOUTS = {"compact": dict(compact=True), "q8": dict(compact=True, quant=True),
           "f32": dict()}
SUMS = {"compact": (tslab.slab_group_sums_compact,
                    tslab.slab_group_sums_compact_plain),
        "q8": (tslab.slab_group_sums_q8, tslab.slab_group_sums_q8_plain),
        "f32": (tslab.slab_group_sums_f32, tslab.slab_group_sums_f32_plain)}


def _sums(fn, layout, table, f, t, w, window, rgb=None):
    """A group-sum wrapper or plain version of ``layout``, re-baking from
    the colours ``rgb`` (their packed palette for compact and q8 plans)."""
    if layout == "f32":
        return fn(table, f, w, window, rgb)
    return fn(table, f, t, w, window,
              None if rgb is None else tslab.pack_rgb24(rgb))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(9)
    xyz, rgb = make_room(rng, n_per_wall=128, size=(4.0, 3.0, 2.5))
    n, m = xyz.shape[0], 1024
    xyz_p = np.concatenate([xyz, rng.normal(size=(m - n, 3)).astype(np.float32)])
    rgb_p = np.concatenate([rgb, rng.random((m - n, 3)).astype(np.float32)])
    rgb_p = (np.round(rgb_p * 255) / 255).astype(np.float32)
    mask = np.arange(m) < n
    img = np.asarray(render_at(xyz, rgb, np.zeros(3, np.float32),
                               np.array([0.2, 0.0, 0.0], np.float32), (32, 64)))
    trans = rng.uniform(-1.0, 1.0, (6, 3)).astype(np.float32)
    rot = np.stack([np.linspace(0, 2 * np.pi, 8, endpoint=False),
                    np.zeros(8), np.zeros(8)], 1).astype(np.float32)
    rgb2 = (np.round(rng.random(rgb_p.shape) * 255) / 255).astype(np.float32)
    return dict(xyz=xyz_p, rgb=rgb_p, mask=mask, img=img, trans=trans,
                rot=rot, rgb2=rgb2)


def _real_slots(plan, f):
    if plan.quant:
        return ((f[:, 0] >> 23) & 0x1FF) < plan.window
    return f[:, 0] >= 0


def _plan(s, builder, layout, window, block, partial):
    trans = s["trans"][:3] if partial else s["trans"]
    geo = dict(window=window, block=block)
    kw = dict(LAYOUTS[layout], tp_is_pid=True, **geo)
    if builder == "port":
        nb = (tslab.plan_required_blocks(s["xyz"], s["mask"], trans, s["rot"],
                                         32, 64, device="cpu", **geo)
              if partial else None)
        return tslab.build_grid_plan(s["xyz"], s["rgb"], s["mask"], trans,
                                     s["rot"], 32, 64, nb=nb, device="cpu",
                                     **kw)
    args = [jnp.asarray(a) for a in (s["xyz"], s["mask"], trans, s["rot"])]
    nb = (jslab.plan_required_blocks(*args, 32, 64, **geo) if partial
          else None)
    jp = jslab.build_grid_plan(args[0], jnp.asarray(s["rgb"]), *args[1:], 32,
                               64, nb=nb, **kw)
    return grid_plan_from_numpy(
        [np.asarray(f) for f in jp.fields], [np.asarray(w) for w in jp.windows],
        jp.n_pairs, jp.height, jp.width, jp.wrap, jp.window, jp.block,
        tps=[np.asarray(t) for t in jp.tps], compact=jp.compact,
        tp_is_pid=jp.tp_is_pid, quant=jp.quant, device="cpu")


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("window,block", [(128, 1024), (256, 512)])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("builder", ["port", "jax"])
def test_real_samples_lead_every_block(scene, builder, layout, window, block,
                                       partial):
    plan = _plan(scene, builder, layout, window, block, partial)
    assert (plan.window, plan.block, plan.quant) == (window, block,
                                                     layout == "q8")
    pad_only = 0
    for f in plan.fields:
        real = _real_slots(plan, f)
        # a prefix in every block: no real slot after a pad slot
        assert not (real[:, 1:] & ~real[:, :-1]).any()
        assert not real[~real[:, 0]].any()
        pad_only += int((~real[:, 0]).sum())
    if not partial:
        assert pad_only > 0  # the bucketed block count leaves pad blocks


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_group_sums_match_jax(scene, layout, refresh):
    s = scene
    jp = jslab.build_grid_plan(
        jnp.asarray(s["xyz"]), jnp.asarray(s["rgb"]), jnp.asarray(s["mask"]),
        jnp.asarray(s["trans"]), jnp.asarray(s["rot"]), 32, 64,
        tp_is_pid=refresh, **LAYOUTS[layout])
    plan = grid_plan_from_numpy(
        [np.asarray(f) for f in jp.fields], [np.asarray(w) for w in jp.windows],
        jp.n_pairs, jp.height, jp.width, jp.wrap, jp.window, jp.block,
        tps=[np.asarray(t) for t in jp.tps], compact=jp.compact,
        tp_is_pid=jp.tp_is_pid, quant=jp.quant, device="cpu")
    tables = jslab._slab_tables(jnp.asarray(s["img"]), 32, 64,
                                window=jp.window)
    table = tslab.slab_table(torch.tensor(s["img"]), window=plan.window)
    rgb2 = torch.tensor(s["rgb2"]) if refresh else None
    sums, _ = SUMS[layout]
    n0 = sums.launches
    compact = layout != "f32"
    tps = plan.tps if compact else [None] * len(plan.fields)
    jtps = jp.tps if compact else [None] * len(jp.fields)
    for jf, jw, jt, f, w, t in zip(jp.fields, jp.windows, jtps, plan.fields,
                                   plan.windows, tps):
        want_tot, want_cnt = jslab.slab_group_partials(
            tables, jf, jw, compact,
            jnp.asarray(s["rgb2"]) if refresh else None, tps=jt,
            window=jp.window, quant=jp.quant)
        tot, cnt = _sums(sums, layout, table, f, t, w, plan.window, rgb2)
        assert tot.shape == cnt.shape == (tslab.GROUP,)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
        np.testing.assert_allclose(tot.numpy(), np.asarray(want_tot),
                                   rtol=1e-5, atol=1e-6)
    assert sums.launches == n0  # CPU tensors: the plain version ran


def _rebaked(layout, f, t, rgb):
    """The group's streams with the targets re-baked from ``rgb`` by a
    separate gather: a copy of an f32 group with new r, g and b rows, or
    the packed targets of a compact or q8 group."""
    if layout != "f32":
        return f, tslab.pack_rgb24(rgb)[t.to(torch.int64)]
    f = f.clone()
    f[:, 3:6] = rgb[f[:, 7].to(torch.int64)].permute(0, 2, 1)
    return f, None


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fused_rebake_equals_separate_gather(scene, layout):
    s = scene
    plan = tslab.build_grid_plan(s["xyz"], s["rgb"], s["mask"], s["trans"],
                                 s["rot"], 32, 64, tp_is_pid=True,
                                 device="cpu", **LAYOUTS[layout])
    table = tslab.slab_table(torch.tensor(s["img"]), window=plan.window)
    rgb2 = torch.tensor(s["rgb2"])
    sums, plain = SUMS[layout]
    tps = plan.tps or [None] * len(plan.fields)
    for f, w, t in zip(plan.fields, plan.windows, tps):
        fused = _sums(sums, layout, table, f, t, w, plan.window, rgb2)
        gathered = _sums(sums, layout, table, *_rebaked(layout, f, t, rgb2),
                         w, plan.window)
        routed = tslab.slab_group_partials(table, f, w, plan.window, rgb2, t,
                                           plan.compact, plan.quant)
        plain_fused = _sums(plain, layout, table, f, t, w, plan.window, rgb2)
        got = [gathered, routed, plain_fused]
        if layout == "f32":  # the zero-padded colours slab_pair_scores passes
            got.append(sums(table, f, w, plan.window, tslab._rgb4(rgb2)))
        for g in got:
            assert torch.equal(fused[0], g[0])
            assert torch.equal(fused[1], g[1])
        assert fused[1].sum() > 0


def _reference_sums(table, fields, windows, pids, rgb, window, layout):
    """Float64 per-sample loop over a plan group, from its definition; the
    targets are the 8-bit colours ``rgb[pid]``."""
    t = table.double().numpy()
    pal = np.round(rgb.double().numpy() * 255.0)
    tot, cnt = np.zeros(128), np.zeros(128)
    f = fields.numpy()
    for b in range(f.shape[0]):
        for i in range(f.shape[2]):
            if layout == "q8":
                p = int(f[b, 0, i]) & 0xFFFFFFFF
                li, cid = p >> 23, (p >> 16) & 0x7F
                x1, y1 = ((p >> 8) & 0xFF) / 255.0, (p & 0xFF) / 255.0
                if li >= window:
                    continue
            elif layout == "f32":
                if f[b, 0, i] < 0 or f[b, 6, i] < 0:
                    continue
                li, cid = int(f[b, 0, i]), int(f[b, 6, i])
                x1, y1 = float(f[b, 1, i]), float(f[b, 2, i])
            else:
                if f[b, 0, i] < 0:
                    continue
                li, cid = divmod(int(f[b, 0, i]), 128)
                x1, y1 = float(f[b, 1, i]), float(f[b, 2, i])
            v = t[int(windows[b]) * window + li]
            s = (v[0:3] * (1 - x1) * (1 - y1) + v[3:6] * x1 * (1 - y1)
                 + v[6:9] * (1 - x1) * y1 + v[9:12] * x1 * y1)
            if not s.any():
                continue  # pure black
            tot[cid] += np.linalg.norm(s - pal[int(pids[b, 0, i])] / 255.0)
            cnt[cid] += 1
    return tot, cnt


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_edge_plans_score_as_the_reference(layout):
    """The card tests' hand-built plans: pad-only blocks, a window run across
    chunks, alternating windows, row window - 1 and pair 127, black rows."""
    rng = np.random.default_rng(12)
    window, block, n_points = 16, 32, 50
    specs = ([(0, 0)] * 3 + [(1, block)] * 5 + [(1, 7)]
             + [(b % 2 * 2, 1 + b) for b in range(6)] + [(3, 0)] * 2)
    rgb = torch.tensor(np.random.default_rng(13).integers(
        0, 256, (n_points, 3)) / 255.0, dtype=torch.float32)
    fields, windows, pids = edge_plan_group(rng, specs, block, window,
                                            n_points, layout, rgb.numpy())
    table = torch.tensor(rng.random((4 * window, 12)), dtype=torch.float32)
    table[::5] = 0.0  # pure-black rows
    sums, _ = SUMS[layout]
    want_tot, want_cnt = _reference_sums(table, fields, windows, pids, rgb,
                                         window, layout)
    for fused in (True, False):
        if fused:
            tot, cnt = _sums(sums, layout, table, fields, pids, windows,
                             window, rgb)
        else:
            tot, cnt = _sums(sums, layout, table,
                             *_rebaked(layout, fields, pids, rgb), windows,
                             window)
        np.testing.assert_array_equal(cnt.numpy(), want_cnt)
        np.testing.assert_allclose(tot.numpy(), want_tot, rtol=1e-5,
                                   atol=1e-5)
    assert cnt[127] > 0 and 0 < cnt.sum() < sum(n for _, n in specs)


def test_group_sums_errors(scene):
    s = scene
    plan = tslab.build_grid_plan(s["xyz"], s["rgb"], s["mask"], s["trans"],
                                 s["rot"], 32, 64, compact=True, quant=True,
                                 tp_is_pid=True, device="cpu")
    table = tslab.slab_table(torch.tensor(s["img"]), window=plan.window)
    f, w, t = plan.fields[0], plan.windows[0], plan.tps[0]
    palette = tslab.pack_rgb24(torch.tensor(s["rgb2"]))
    with pytest.raises(TypeError, match="dtypes"):
        tslab.slab_group_sums_q8(table, f, t, w, plan.window, palette.double())
    with pytest.raises(ValueError, match="palette must be"):
        tslab.slab_group_sums_q8(table, f, t, w, plan.window, palette[None])
    with pytest.raises(ValueError, match="window <= 256"):
        tslab.slab_group_sums_q8(torch.zeros(1024, 12), f, t, w, 512)
    with pytest.raises(ValueError, match=r"\(NB, 3, block\)"):
        tslab.slab_group_sums_compact(table, f, t, w, plan.window)
    with pytest.raises(ValueError, match=r"\(NB, 8, block\)"):
        tslab.slab_group_sums_f32(table, f, w, plan.window)
    f32 = tslab.build_grid_plan(s["xyz"], s["rgb"], s["mask"], s["trans"],
                                s["rot"], 32, 64, device="cpu")
    rgb2 = torch.tensor(s["rgb2"])
    for bad in (rgb2[:, :2], rgb2[None], rgb2[:, 0]):
        with pytest.raises(ValueError, match=r"rgb must be \(N, 3\)"):
            tslab.slab_group_sums_f32(table, f32.fields[0], f32.windows[0],
                                      f32.window, bad)
    with pytest.raises(TypeError, match="dtypes"):
        tslab.slab_group_sums_f32(table, f32.fields[0], f32.windows[0],
                                  f32.window, rgb2.double())
