"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: these need an NVIDIA GPU with nvcc and skip elsewhere.
Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``
(``tests/conftest.py`` imports jax).  Histograms are bit-exact on 0/1
masks and the same bits from run to run on any mask; slab counts are exact
and sums agree within rtol 1e-5 (the kernels add the floats in another
order than the plain versions).  The group-sum kernels of all three plan
layouts are also held on hand-built edge plans, fused and unfused.  The
device colour functions run through the histogram kernels and their plain
versions, and one served request equals the harness's fused query.  The two
tests of launches on a card that is not the current one need two cards.
The descent's captured graph equals the eager loop bit for bit (default,
prune, multires, trajectory), its results are clones that later replays
leave alone, and pruned survivors and batched tracking streams stay within
5e-3 and 1e-3 of their unbatched descents.  On a mesh (``parallel``): a
one-card mesh that repeats cuda:0 gives graphed and eager descents the same
bits and the single-device query's starts and winner; a two-card mesh gives
the one-card mesh's bits, and ``query_devices = 2`` serves on both cards
(these two skip on one card).  The executable cache builds the five
kernel libraries and the JPEG codec, then hits all six; a graph captured
under ``utils.maybe_trace`` gives the bits of one captured without it.
The descent step's two kernels (``kernels/descent_step.py``) at the
OmniScenes cell's shapes (240,000 points, a 2048x1024 panorama, 6 starts on
one table and 3 stacked streams), by ``scripts/bench_descent_step.py``'s
checks and bounds: against their plain version over every table dtype,
wrap and mask; two runs of the captured step give the same bits; the
cell's 6 x 100 descent against the autograd step from starts near the
pose; and a traced descent counts its 100 steps as
``descent.steps_kernel``.
Stage 1's pick at the library's and the Stanford CLI's shapes is the f32
plan, whole, and it scores faster than the gather engine.
"""

import dataclasses

import numpy as np
import pytest
import torch

from piccolo_tpu_torch.kernels.block_histogram import (
    block_histogram,
    block_histogram_plain,
)
from piccolo_tpu_torch.kernels import slab_sampling as slab
from piccolo_tpu_torch.kernels.histogram import (
    masked_histogram_counts,
    masked_histogram_counts_plain,
)
from piccolo_tpu_torch.testing import make_room, render_at

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _histogram_inputs(B, N, num_bins, kind, seed):
    """(B, N) ids and mask: runs of one bin and of one mask value (coherent,
    as stage 2's rendered blocks) or uniform ids in [-3, num_bins + 18);
    row 0 all masked, row 1 all unmasked, some mask values 0.25."""
    rng = np.random.default_rng(seed)
    n = B * N
    if kind == "coherent":
        runs = n // 20 + 2
        ids = np.repeat(rng.integers(-3, num_bins + 18, runs),
                        rng.integers(1, 40, runs))
        mask = np.repeat(rng.choice([0.0, 0.25, 1.0], runs, p=[0.2, 0.1, 0.7]),
                         rng.integers(1, 40, runs))
        ids, mask = np.resize(ids, n), np.resize(mask, n)
    else:
        ids = rng.integers(-3, num_bins + 18, n)
        mask = rng.choice([0.0, 0.25, 1.0], n, p=[0.3, 0.1, 0.6])
    ids = ids.reshape(B, N).astype(np.int32)
    mask = mask.reshape(B, N).astype(np.float32)
    mask[0] = 0.0
    if B > 1:
        mask[1] = 1.0
    return ids, mask


def _on_card(a, dev, misaligned):
    """``a`` on the card, contiguous; one element into its storage when
    ``misaligned`` (so a row's 16 B vectors start off its first entry)."""
    t = torch.from_numpy(a).to(dev)
    if not misaligned:
        return t
    buf = torch.empty(a.size + 1, dtype=t.dtype, device=dev)
    view = buf[1:].view(a.shape)
    view.copy_(t)
    return view


# (B, N, num_bins): library/Stanford stage 2, a mesh shard's, a tracked
# frame's colour match, OmniScenes stage 2, ragged N, N under one 16 B
# vector a lane, and wide histograms
BH_SHAPES = [(320, 8192, 512), (128, 8192, 512), (3072, 2048, 256),
             (800, 131072, 512), (7, 3001, 512), (5, 7, 512),
             (64, 8192, 1000), (33, 4099, 256)]


@pytest.mark.parametrize("layout", ["aligned", "misaligned", "mask_misaligned"])
@pytest.mark.parametrize("kind", ["coherent", "uniform"])
@pytest.mark.parametrize("B,N,num_bins", BH_SHAPES)
def test_block_histogram_kernel_bit_exact(dev, B, N, num_bins, kind, layout):
    """Bit-exact against the plain version, one launch; misaligned: ids and
    mask both one element into their storage (vectors after a scalar
    head), mask_misaligned: only mask (every entry one at a time)."""
    ids_np, mask_np = _histogram_inputs(B, N, num_bins, kind, B * N + num_bins)
    ids = _on_card(ids_np, dev, layout == "misaligned")
    mask = _on_card(mask_np, dev, layout != "aligned")
    assert ids.is_contiguous() and mask.is_contiguous()
    want = block_histogram_plain(ids, mask, num_bins)
    n0 = block_histogram.launches
    got = block_histogram(ids, mask, num_bins)
    torch.cuda.synchronize()
    assert block_histogram.launches == n0 + 1
    assert torch.equal(got, want)
    assert float(got[0].sum()) == 0.0


def test_block_histogram_refused_launch_raises(dev, monkeypatch):
    """A launch the card refuses (CTAs of 2048 threads, above any card's
    1024) raises and counts no launch: no quiet fallback."""
    from piccolo_tpu_torch.kernels import block_histogram as bh

    monkeypatch.setattr(bh, "cta_threads", lambda *a: 2048)
    ids = torch.zeros((4, 8192), dtype=torch.int32, device=dev)
    n0 = bh.block_histogram.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        bh.block_histogram(ids, torch.ones((4, 8192), device=dev))
    assert bh.block_histogram.launches == n0


def test_slab_kernel_matches_plain(dev):
    """The f32 group-sum kernel on an f32 plan, with the targets in the
    plan and re-baked from new colours in the kernel."""
    rng = np.random.default_rng(3)
    xyz, rgb = make_room(rng, n_per_wall=700)
    img = render_at(xyz, rgb, np.zeros(3, np.float32),
                    np.array([0.4, 0.1, 0.0], np.float32), (64, 128), device=dev)
    trans = rng.uniform(-1.0, 1.0, (5, 3)).astype(np.float32)
    rot = np.stack([np.linspace(0, 6.28, 8, endpoint=False), np.zeros(8),
                    np.zeros(8)], 1).astype(np.float32)
    plan = slab.build_grid_plan(xyz, rgb, None, trans, rot, 64, 128, device=dev)
    table = slab.slab_table(img, window=plan.window)
    rgb2 = torch.tensor(rng.random(rgb.shape), dtype=torch.float32, device=dev)
    for f, w in zip(plan.fields, plan.windows):
        for colours in (None, rgb2, slab._rgb4(rgb2)):
            want = slab.slab_group_sums_f32_plain(table, f, w, plan.window,
                                                  colours)
            n0 = slab.slab_group_sums_f32.launches
            got = slab.slab_group_sums_f32(table, f, w, plan.window, colours)
            torch.cuda.synchronize()
            assert slab.slab_group_sums_f32.launches == n0 + 1
            _assert_sums(got, want)


@pytest.mark.parametrize("num_bins", [512, 12288])
@pytest.mark.parametrize("N", [1, 5, 3001, 524288])
def test_masked_histogram_kernel_bit_exact(dev, N, num_bins):
    """0/1 masks: bit-exact, also from a base that is not 16 B aligned (a
    slice at offset 1 of ids, of the mask, or of both)."""
    g = torch.Generator(device="cpu").manual_seed(N + num_bins)
    ids = torch.randint(-3, num_bins + 18, (N + 1,), generator=g,
                        dtype=torch.int32).to(dev)
    mask = (torch.rand((N + 1,), generator=g) < 0.7).to(torch.float32).to(dev)
    for a, b in ((0, 0), (1, 1), (1, 0), (0, 1)):
        i, m = ids[a:a + N], mask[b:b + N]
        n0 = masked_histogram_counts.launches
        got = masked_histogram_counts(i, m, num_bins)
        torch.cuda.synchronize()
        assert masked_histogram_counts.launches == n0 + 1
        assert torch.equal(got, masked_histogram_counts_plain(i, m, num_bins))


@pytest.mark.parametrize("N", [3001, 524288])
def test_masked_histogram_kernel_repeatable(dev, N):
    """Random-valued masks: the same bits on every call, and within f32
    rounding of the plain version."""
    g = torch.Generator(device="cpu").manual_seed(N)
    ids = torch.randint(0, 512, (N,), generator=g, dtype=torch.int32).to(dev)
    mask = torch.randn((N,), generator=g).to(dev)
    first = masked_histogram_counts(ids, mask)
    for _ in range(3):
        assert torch.equal(masked_histogram_counts(ids, mask), first)
    torch.testing.assert_close(first, masked_histogram_counts_plain(ids, mask),
                               rtol=1e-4, atol=1e-3)


SUMS = {"compact": (slab.slab_group_sums_compact,
                    slab.slab_group_sums_compact_plain),
        "q8": (slab.slab_group_sums_q8, slab.slab_group_sums_q8_plain),
        "f32": (slab.slab_group_sums_f32, slab.slab_group_sums_f32_plain)}


def _assert_sums(got, want):
    """Counts exact; sums rtol 1e-5 (the kernel adds the floats in another
    order than the plain version)."""
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["compact", "q8"])
def test_slab_layout_kernels_match_plain(dev, layout):
    rng = np.random.default_rng(4)
    xyz, rgb = make_room(rng, n_per_wall=700)
    img = render_at(xyz, rgb, np.zeros(3, np.float32),
                    np.array([0.4, 0.1, 0.0], np.float32), (64, 128), device=dev)
    trans = rng.uniform(-1.0, 1.0, (5, 3)).astype(np.float32)
    rot = np.stack([np.linspace(0, 6.28, 8, endpoint=False), np.zeros(8),
                    np.zeros(8)], 1).astype(np.float32)
    plan = slab.build_grid_plan(xyz, rgb, None, trans, rot, 64, 128,
                                compact=True, tp_is_pid=True,
                                quant=layout == "q8", device=dev)
    table = slab.slab_table(img, window=plan.window)
    kernel, plain = SUMS[layout]
    palette = slab.pack_rgb24(torch.tensor(rgb, device=dev))
    for f, w, tp in zip(plan.fields, plan.windows, plan.tps):
        tps = palette[tp.to(torch.int64)]  # the re-bake as a gather
        for args in ((tp, palette), (tps, None)):  # fused, then unfused
            n0 = kernel.launches
            got = kernel(table, f, args[0], w, plan.window, args[1])
            want = plain(table, f, args[0], w, plan.window, args[1])
            torch.cuda.synchronize()
            assert kernel.launches == n0 + 1
            _assert_sums(got, want)


def _edge_cases(block):
    """Per-block (window, real samples) specs of hand-built plan groups."""
    return {
        "all pad": [(0, 0)] * 37,
        # one window over 27 blocks: across chunks of 8 and CTAs
        "long run": [(0, 0)] * 3 + [(2, block)] * 26 + [(2, 5)] + [(0, 0)] * 9,
        "alternating": [(b % 2, block - 3 * b) for b in range(21)],
        # nb = 37 is no multiple of the CTA counts below
        "mixed": ([(1, block)] * 9 + [(3, 1)] + [(0, 0)] * 2
                  + [(b % 3, block // 2) for b in range(20)] + [(3, 0)] * 5),
    }


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("window,block", [(128, 1024), (256, 512)])
@pytest.mark.parametrize("layout", ["compact", "q8", "f32"])
def test_slab_sums_kernels_on_edge_plans(dev, layout, window, block, fused):
    """Pad-only blocks, a window run across chunk and CTA boundaries,
    alternating windows, row window - 1 and pair 127 in every block,
    pure-black table rows, several grids and chunk sizes."""
    from piccolo_tpu_torch.testing import edge_plan_group

    rng = np.random.default_rng(window + block + fused)
    n_points = 3000
    table = torch.rand((4 * window, 12), generator=torch.Generator().manual_seed(
        window), dtype=torch.float32)
    table[::7] = 0.0  # pure-black rows
    table[window - 1::window][1::2] = 0.0  # black last rows
    table = table.to(dev)
    rgb = torch.rand((n_points, 3), device=dev)
    # an f32 plan's own targets, which a fused call replaces by rgb's
    baked = rng.random((n_points, 3)).astype(np.float32)
    kernel, plain = SUMS[layout]
    code = {"compact": slab._COMPACT, "q8": slab._Q8, "f32": slab._F32}[layout]
    for name, specs in _edge_cases(block).items():
        f, w, pids = edge_plan_group(rng, specs, block, window, n_points,
                                     layout, baked, device=dev)
        if layout == "f32":
            tps, pal = None, (slab._rgb4(rgb) if fused else None)
            want = plain(table, f, w, window, pal)
        else:
            palette = slab.pack_rgb24(rgb)
            tps, pal = (pids, palette) if fused else (
                palette[pids.to(torch.int64)], None)
            want = plain(table, f, tps, w, window, pal)
        for chunk, ctas in ((8, None), (8, 3), (1, 4), (32, 1), (5, 2)):
            got = slab._group_sums(kernel, code, table, f, tps, w, window,
                                   pal, chunk=chunk, ctas=ctas)
            torch.cuda.synchronize()
            _assert_sums(got, want)
        if name == "all pad":
            assert int(want[1].sum()) == 0
        else:
            assert want[1][127] > 0


@pytest.fixture
def two_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_kernels_launch_on_a_card_that_is_not_current(two_cards):
    """Each wrapper launches on its tensors' card, whichever card is
    current, and leaves the current card as it was."""
    current, other = two_cards
    torch.cuda.set_device(current)
    g = torch.Generator(device="cpu").manual_seed(5)
    ids = torch.randint(-3, 530, (7, 3001), generator=g,
                        dtype=torch.int32).to(other)
    mask = (torch.rand((7, 3001), generator=g) < 0.7).to(torch.float32).to(other)
    assert torch.equal(block_histogram(ids, mask),
                       block_histogram_plain(ids, mask))
    assert torch.equal(masked_histogram_counts(ids[0], mask[0]),
                       masked_histogram_counts_plain(ids[0], mask[0]))
    rng = np.random.default_rng(4)
    xyz, rgb = make_room(rng, n_per_wall=700)
    img = render_at(xyz, rgb, np.zeros(3, np.float32),
                    np.array([0.4, 0.1, 0.0], np.float32), (64, 128),
                    device=other)
    trans = rng.uniform(-1.0, 1.0, (5, 3)).astype(np.float32)
    rot = np.stack([np.linspace(0, 6.28, 8, endpoint=False), np.zeros(8),
                    np.zeros(8)], 1).astype(np.float32)
    rgb2 = rng.random(rgb.shape).astype(np.float32)
    for kw, colours in ((dict(), None), (dict(), rgb2),
                        (dict(compact=True), None),
                        (dict(compact=True, quant=True), None)):
        plan = slab.build_grid_plan(xyz, rgb, None, trans, rot, 64, 128,
                                    device=other, **kw)
        n0 = slab.slab_group_sums_f32.launches
        got = slab.slab_pair_scores(img, plan, None if colours is None else
                                    torch.tensor(colours, device=other))
        want = slab.slab_pair_scores(img.cpu(), dataclasses.replace(
            plan, fields=tuple(f.cpu() for f in plan.fields),
            windows=tuple(w.cpu() for w in plan.windows),
            tps=tuple(t.cpu() for t in plan.tps)),
            None if colours is None else torch.tensor(colours))
        torch.cuda.synchronize(other)
        assert got.device == other
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
        if not kw:  # every f32 group is one launch of the group-sum kernel
            assert slab.slab_group_sums_f32.launches == n0 + len(plan.fields)
    n0 = masked_histogram_counts.launches
    got = masked_histogram_counts(ids[0, 1:], mask[0, 1:], 12288)
    assert masked_histogram_counts.launches == n0 + 1
    assert torch.equal(got, masked_histogram_counts_plain(ids[0, 1:],
                                                          mask[0, 1:], 12288))
    assert torch.cuda.current_device() == current.index


def test_cli_device_index_runs_on_that_card(two_cards, tmp_path):
    """``device_index = 1`` runs the whole CLI on the second card, with the
    winners of ``device_index = 0``."""
    import csv
    import os

    from piccolo_tpu_torch.main import main as tmain
    from piccolo_tpu_torch.testing import write_synth_stanford

    root = str(tmp_path / "data")
    write_synth_stanford(root, rooms=1, queries=2, points=12000, height=128,
                         seed=7, oracle="raycast")
    config = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "stanford.ini")
    winners = []
    for i in (0, 1):
        log = str(tmp_path / f"log{i}")
        n0 = slab.slab_group_sums_q8.launches
        tmain(["--config", config, "--log", log, "--no-tensorboard",
               "--override", f"data_root={root},device_index={i},"
               "slab_init=True,slab_quant=True,num_iter=20"])
        assert slab.slab_group_sums_q8.launches > n0
        with open(os.path.join(log, "stanford_results.csv")) as f:
            rows = list(csv.reader(f))[1:]
        winners.append(np.array([[float(v) for v in r[5].split()]
                                 for r in rows]))
    assert winners[0].shape == (2, 3)
    np.testing.assert_allclose(winners[1], winners[0], atol=1e-4)


def test_device_colour_kernels_match_plain(dev, monkeypatch):
    """color_match_device and color_mod_device through the histogram
    kernels against the same functions on the kernels' plain versions, on
    the card: the same images bit for bit, one launch of each kernel; and
    the host colour functions within the JAX package's tolerances."""
    from piccolo_tpu_torch import color
    from piccolo_tpu_torch.convert import (
        cdf_from_numpy,
        sharpen_state_from_numpy,
    )
    from piccolo_tpu_torch.kernels import block_histogram as bh
    from piccolo_tpu_torch.kernels import histogram as mh

    rng = np.random.default_rng(11)
    img = (rng.random((128, 256, 3)) * 255).astype(np.uint8)
    img = img.astype(np.float32) / 255.0
    img[:6, :9] = 0.0
    rgb = (rng.random((5000, 3)) * 255).astype(np.uint8).astype(np.float32) / 255.0
    cdf = cdf_from_numpy(color.cloud_color_cdf(rgb), dev)
    st = sharpen_state_from_numpy(color.cloud_sharpen_state(rgb, pad_to=6144),
                                  dev)
    img_d = torch.tensor(img, device=dev)
    n_bh, n_mh = bh.block_histogram.launches, mh.masked_histogram_counts.launches
    matched = color.color_match_device(img_d, *cdf)
    sharp, cloud = color.color_mod_device(img_d, st)
    torch.cuda.synchronize()
    assert bh.block_histogram.launches == n_bh + 1
    assert mh.masked_histogram_counts.launches == n_mh + 1
    monkeypatch.setattr(bh, "block_histogram", bh.block_histogram_plain)
    monkeypatch.setattr(mh, "masked_histogram_counts",
                        mh.masked_histogram_counts_plain)
    assert torch.equal(matched, color.color_match_device(img_d, *cdf))
    sharp_p, cloud_p = color.color_mod_device(img_d, st)
    assert torch.equal(sharp, sharp_p) and torch.equal(cloud, cloud_p)
    host = color.color_match(img.copy(), rgb)
    assert np.abs(matched.cpu().numpy() - host).max() < 1e-5
    h_img, h_rgb = color.color_mod(img.copy(), rgb, 256)
    assert np.abs(sharp.cpu().numpy() - h_img).max() <= 1.001 / 255.0
    assert np.abs(cloud[:5000].cpu().numpy() - h_rgb).max() <= 1.001 / 255.0
    assert torch.all(cloud[5000:] == 0.0)


def test_served_request_equals_run_fused(dev):
    """One request through LocalizeService on the card equals the harness's
    _run_fused on the same room and image bit for bit, through a forced f32
    plan (the slab kernel) and the block-histogram kernel."""
    from piccolo_tpu_torch.harness.localize import _run_fused
    from piccolo_tpu_torch.serve import LocalizeService

    rng = np.random.default_rng(5)
    xyz, rgb = make_room(rng, n_per_wall=1500, texture="checker")
    img = render_at(xyz, rgb, np.float32([0.4, -0.2, 0.15]),
                    np.float32([0.9, 0, 0]), (128, 256), device="cpu").numpy()
    img = (img * 255).astype(np.uint8)
    svc = LocalizeService(
        device=dev, xy_only=True, num_trans=16, yaw_only=True, num_yaw=4,
        z_prior=None, num_split_h=4, num_split_w=4, num_intermediate=8,
        num_input=4, num_iter=60, lr=0.1, patience=5, factor=0.8,
        slab_init=True, slab_background_build=False)
    svc.load_room(xyz, rgb, name="box")
    n_slab, n_bh = slab.slab_group_sums_f32.launches, block_histogram.launches
    out = svc.localize(img)
    assert slab.slab_group_sums_f32.launches > n_slab
    assert block_histogram.launches > n_bh
    cache = svc._rooms["box"][0]
    img_init, img_main, rgb_used, _ = svc._prepare(img, cache)
    res, _ = _run_fused(img_init, img_main, cache, rgb_used, svc.cfg,
                        svc.init_dict, cache["grids"], sync_plans=True)
    np.testing.assert_array_equal(out["t"], res.t.cpu().numpy())
    assert out["loss"] == float(res.loss)
    assert np.linalg.norm(out["t"] - np.float32([0.4, -0.2, 0.15])) < 0.2


@pytest.mark.parametrize("shape", ["library", "stanford.ini"])
def test_stage1_pick_on_the_card(dev, shape):
    """The ladder's stage-1 pick on the card at the library's shapes (60,000
    points, 512x256 init, 50 trans x 8 yaws) and the Stanford CLI's
    (1024x512 init, configs/stanford.ini's grids and its sharpen_color
    re-bake): the f32 plan, whole, at the card's geometry, and it scores
    stage 1 faster than the gather engine at the card's chunk."""
    import os
    import time

    from piccolo_tpu_torch.config import make_config, parse_ini
    from piccolo_tpu_torch.harness import localize as hl
    from piccolo_tpu_torch.init.candidates import default_init_dict
    from piccolo_tpu_torch.init.refine import _score_pairs, gather_chunk

    rng = np.random.default_rng(7)
    xyz, rgb = make_room(rng, n_per_wall=10000, texture="checker")
    xyz_d, rgb_d, mask_d = hl._pad_cloud(xyz, rgb, dev)
    if shape == "library":
        init = default_init_dict(xy_only=True, yaw_only=True, num_yaw=8,
                                 num_split_h=4, num_split_w=4, num_trans=50,
                                 z_prior=None)
        hw, sharpen = (256, 512), False
    else:
        ini = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", "stanford.ini")
        init, hw, sharpen = hl.get_init_dict(parse_ini(ini)), (512, 1024), True
    grids = hl._FusedGrids(xyz, init, dev)
    img = render_at(xyz, rgb, np.float32([0.4, -0.2, 0.15]),
                    np.float32([0.9, 0, 0]), hw, device=dev)
    cfg = make_config(dataset="Stanford2D-3D-S", sharpen_color=sharpen,
                      slab_init="auto", slab_background_build=False)
    cache = dict(xyz=xyz_d, rgb=rgb_d, mask=mask_d, device=dev)
    n_pairs = grids.n_trans * int(grids.rot.shape[0])
    adm = hl._slab_admission(cfg, cache, grids, img)
    assert adm is not None and not adm["compact"] and not adm["quant"]
    assert adm["n_t_build"] == grids.n_trans
    plan = hl._maybe_slab_plan(cfg, cache, grids, img, sync=True)
    assert plan is not None and not plan.compact
    assert plan.n_pairs == n_pairs
    assert (plan.window, plan.block) == slab.resolve_plan_geometry(
        int(mask_d.shape[0]), *hw, device=dev) == (128, 1024)
    pair_t, pair_r = slab.make_pairs(grids.trans[:grids.n_trans], grids.rot)
    chunk = gather_chunk(int(mask_d.shape[0]), dev)
    palette = rgb_d if sharpen else None

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t_slab = wall(lambda: slab.slab_pair_scores(img, plan, palette))
    t_gather = wall(lambda: _score_pairs(img, xyz_d, rgb_d, pair_t, pair_r,
                                         mask_d, chunk))
    assert t_slab < t_gather, (t_slab, t_gather)


@pytest.fixture
def descent_scene(dev):
    """A room on the card, a 128x256 query and 6 starts near its pose."""
    return _descent_scene(dev)


def _descent_scene(dev):
    from piccolo_tpu_torch.harness.localize import _order_bounds, _pad_cloud

    rng = np.random.default_rng(5)
    xyz, rgb = make_room(rng, n_per_wall=1500, texture="checker")
    xyz_d, rgb_d, mask_d = _pad_cloud(xyz, rgb, dev)
    lo, hi = (torch.tensor(b, device=dev) for b in _order_bounds(xyz, 0.05))
    img = render_at(xyz, rgb, np.float32([0.4, -0.2, 0.15]),
                    np.float32([0.9, 0, 0]), (128, 256), device=dev)
    t0 = torch.tensor(np.float32([0.4, -0.2, 0.15])
                      + rng.uniform(-0.3, 0.3, (6, 3)).astype(np.float32),
                      device=dev)
    y0 = torch.zeros((6, 3), device=dev)
    y0[:, 0] = torch.tensor(0.9 + rng.uniform(-0.4, 0.4, 6), device=dev)
    return img, xyz_d, rgb_d, mask_d, lo, hi, t0, y0


def _descend(scene, eager, **kw):
    from piccolo_tpu_torch.solver import descend_starts

    img, xyz, rgb, mask, lo, hi, t0, y0 = scene
    return descend_starts(img, xyz, rgb, t0, y0, lo, hi, mask, 60, 0.1, 5,
                          0.8, "float32", trajectory=kw.pop("trajectory",
                                                            False),
                          _eager=eager, **kw)


@pytest.mark.parametrize("mode", ["default", "prune", "multires",
                                  "trajectory"])
def test_graph_equals_eager(descent_scene, mode):
    """The captured step replayed equals the eager loop on the card bit for
    bit: final poses, losses and learning rates (and every trajectory
    step)."""
    from piccolo_tpu_torch import solver

    kw = {"default": {}, "prune": dict(prune=(20, 2)),
          "multires": dict(multires=(30, 2)),
          "trajectory": dict(trajectory=True)}[mode]
    got = _descend(descent_scene, False, **dict(kw))
    want = _descend(descent_scene, True, **dict(kw))
    torch.cuda.synchronize()
    for a, b in zip(got[0].leaves(), want[0].leaves()):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    if mode == "trajectory":
        for a, b in zip(got[3].leaves(), want[3].leaves()):
            assert a.shape[:2] == (6, 60) and torch.equal(a, b)
    stats = solver.graph_stats()["graphs"]
    assert stats and all(s["pool_bytes"] > 0 and s["capture_s"] > 0
                         and s["replays"] > 0 for s in stats)


def test_concurrent_misses_capture_once(descent_scene):
    """Four threads missing one key at once capture it once, and each gets
    the eager loop's bits."""
    import threading

    from piccolo_tpu_torch import solver

    img, xyz, rgb, mask, lo, hi, t0, y0 = descent_scene
    scene = (img, xyz, rgb, mask, lo, hi, t0[:5], y0[:5])  # a new key
    want = _descend(scene, True)
    before = solver.graph_stats()["captures"]
    outs, gate = [None] * 4, threading.Barrier(4)

    def go(i):
        gate.wait()
        outs[i] = _descend(scene, False)
        torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert solver.graph_stats()["captures"] == before + 1
    for got in outs:
        assert torch.equal(got[0].t, want[0].t)
        assert torch.equal(got[1], want[1])


def test_eviction_and_recapture(descent_scene, monkeypatch):
    """With no room for graphs, each new key evicts the last one; a key
    captured again is counted as a recapture and still gives the eager
    loop's bits."""
    from piccolo_tpu_torch import solver

    monkeypatch.setattr(solver, "GRAPH_MEM_FRACTION", 0.0)
    img, xyz, rgb, mask, lo, hi, t0, y0 = descent_scene
    # 7 and 8 starts: keys no other test captures
    a = (img, xyz, rgb, mask, lo, hi, torch.cat([t0, t0[:1]]),
         torch.cat([y0, y0[:1]]))
    b = (img, xyz, rgb, mask, lo, hi, torch.cat([t0, t0[:2]]),
         torch.cat([y0, y0[:2]]))
    # the LRU is per card: count this card's graphs (the two-card tests
    # leave graphs on another one)
    def graphs(stats):
        return [g for g in stats["graphs"] if g["device"] == str(t0.device)]

    _descend(a, False)
    assert len(graphs(solver.graph_stats())) == 1
    c0 = solver.graph_stats()
    _descend(b, False)  # evicts a's graph
    c1 = solver.graph_stats()
    got = _descend(a, False)
    c2 = solver.graph_stats()
    assert len(graphs(c1)) == 1 and len(graphs(c2)) == 1
    assert c1["evictions"] == c0["evictions"] + 1
    assert c2["evictions"] == c1["evictions"] + 1
    assert c2["captures"] == c1["captures"] + 1
    assert c2["recaptures"] == c1["recaptures"] + 1
    want = _descend(a, True)
    assert torch.equal(got[0].t, want[0].t) and torch.equal(got[1], want[1])


def test_pruned_survivors_near_unpruned(descent_scene):
    """Prune on the card: each survivor finishes within 5e-3 m and 5e-3 rad
    of the same start's unpruned descent, and every pruned row reports its
    phase-1 state.  On the CPU a survivor ends bit for bit where it would
    unpruned; on the card its second phase runs a batch of 2, whose
    reductions add in another order, and 40 steps at lr 0.1 carry that to
    1.6e-3 here (an H100)."""
    from piccolo_tpu_torch.solver import descend_starts

    img, xyz, rgb, mask, lo, hi, t0, y0 = descent_scene
    full = _descend(descent_scene, False)
    pruned = _descend(descent_scene, False, prune=(20, 2))
    head = descend_starts(img, xyz, rgb, t0, y0, lo, hi, mask, 20, 0.1, 5,
                          0.8, "float32")
    keep = torch.argsort(head[1], stable=True)[:2].tolist()
    for k in range(6):
        a = torch.cat([pruned[0].t[k], pruned[0].ypr()[k]])
        src = full if k in keep else head
        b = torch.cat([src[0].t[k], src[0].ypr()[k]])
        if k in keep:
            d = float((a - b).abs().max())
            assert d < 5e-3, (k, d, a, b)
        else:
            assert torch.equal(a, b)


def test_returned_tensors_survive_later_replays(descent_scene):
    """Results are clones: a second descent of another shape, then the first
    shape again on other starts, leave the first call's tensors as they
    were."""
    first = _descend(descent_scene, False)
    kept = [x.clone() for x in (*first[0].leaves(), first[1], first[2])]
    img, xyz, rgb, mask, lo, hi, t0, y0 = descent_scene
    _descend((img, xyz, rgb, mask, lo, hi, t0[:3], y0[:3]), False)
    _descend((img, xyz, rgb, mask, lo, hi, t0 + 0.05, y0), False)
    torch.cuda.synchronize()
    for a, b in zip((*first[0].leaves(), first[1], first[2]), kept):
        assert torch.equal(a, b)


def _tracked_frames(scene):
    """Four frames of the scene's room 3 cm apart, yaw 0.9 + 0.02 k, and
    their poses."""
    img, xyz, rgb, mask = scene[:4]
    steps = np.float32([[0.0, 0.0, 0.0], [0.03, -0.02, 0.0],
                        [0.06, -0.03, 0.01], [0.09, -0.02, 0.0]])
    gt = np.float32([0.4, -0.2, 0.15]) + steps
    xyz_h, rgb_h = xyz.cpu().numpy(), rgb.cpu().numpy()
    keep = mask.cpu().numpy()
    imgs = torch.stack([render_at(xyz_h[keep], rgb_h[keep], t,
                                  np.float32([0.9 + 0.02 * i, 0, 0]),
                                  (128, 256), device=img.device)
                        for i, t in enumerate(gt)])
    return imgs, gt


def test_track_steps_batched_on_the_card(descent_scene):
    """K = 4 streams of tracked frames (3 cm steps) in one graphed descent:
    K = 1 equals track_step bit for bit, and each stream of the batch its
    own track_step within 1e-3 m and 1e-3 rad (the batch's backward adds a
    stream's gradient terms in another order)."""
    from piccolo_tpu_torch import tracking as T

    img, xyz, rgb, mask, lo, hi, _, _ = descent_scene
    imgs, gt = _tracked_frames(descent_scene)
    ts = gt + np.float32([0.03, -0.02, 0.01])
    ys = np.float32([[0.93 + 0.02 * i, 0, 0] for i in range(4)])
    batch = T.track_steps_batched(imgs, xyz, rgb, ts, ys, lo, hi, mask,
                                  device=img.device)
    for k in range(4):
        one = T.track_step_fetched(imgs[k], xyz, rgb, ts[k], ys[k], lo, hi,
                                   mask, device=img.device)
        solo = T.track_steps_batched(imgs[k:k + 1], xyz, rgb, ts[k:k + 1],
                                     ys[k:k + 1], lo, hi, mask,
                                     device=img.device)[0]
        for a, b in zip(solo[:3], one[:3]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(batch[k][:2], one[:2]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
        assert np.linalg.norm(batch[k][0] - gt[k]) < 0.05


def test_track_batch_gap_is_reduction_order(descent_scene):
    """The witness for the bounds on batched streams: in a K = 4 batch of
    frames that descend far apart (the scene's frame, rolled, flipped, and
    flipped and rolled, from starts up to 0.3 m off), each stream ends bit
    for bit where it ends in a K = 4 batch of four copies of itself, and
    the copies agree with each other.  So a stream reads only its own
    frame, start and table rows, and what moves it from its single step is
    the batch's shape: the order in which a K-row reduction adds."""
    from piccolo_tpu_torch import tracking as T

    img, xyz, rgb, mask, lo, hi, t0, y0 = descent_scene
    t, y = t0.cpu().numpy()[:4], y0.cpu().numpy()[:4]
    imgs = torch.stack([img, img.roll(64, 1), img.flip(1),
                        img.flip(1).roll(-32, 1)])
    batch = T.track_steps_batched(imgs, xyz, rgb, t, y, lo, hi, mask,
                                  device=img.device)
    gaps = []
    for k in range(4):
        copies = T.track_steps_batched(
            imgs[k:k + 1].repeat(4, 1, 1, 1), xyz, rgb,
            np.repeat(t[k:k + 1], 4, 0), np.repeat(y[k:k + 1], 4, 0), lo,
            hi, mask, device=img.device)
        for c in copies:
            for a, b in zip(c[:3], batch[k][:3]):
                np.testing.assert_array_equal(a, b)
        one = T.track_step_fetched(imgs[k], xyz, rgb, t[k], y[k], lo, hi,
                                   mask, device=img.device)
        gaps.append(max(float(np.abs(a - b).max())
                        for a, b in zip(batch[k][:2], one[:2])))
    print(f"flipped and rolled frames, streams from their single steps: "
          f"{[f'{g:.3g}' for g in gaps]}")


def test_track_steps_batched_far_starts(descent_scene):
    """K = 4 tracked frames (3 cm apart) from starts up to 0.3 m and 0.4
    rad off: each stream ends within 1e-2 m and 1e-2 rad of its own
    track_step.  The gap is the batch's reduction order (the witness
    above), carried further by 30 steps at lr 0.1 from far starts than
    from 3 cm (PERF.md, section 6, has the readings)."""
    from piccolo_tpu_torch import tracking as T

    img, xyz, rgb, mask, lo, hi, t0, y0 = descent_scene
    imgs, gt = _tracked_frames(descent_scene)
    off = t0.cpu().numpy()[:4] - np.float32([0.4, -0.2, 0.15])
    ts = gt + off
    ys = y0.cpu().numpy()[:4] + np.float32([[0.02 * i, 0, 0]
                                            for i in range(4)])
    batch = T.track_steps_batched(imgs, xyz, rgb, ts, ys, lo, hi, mask,
                                  device=img.device)
    gaps = []
    for k in range(4):
        one = T.track_step_fetched(imgs[k], xyz, rgb, ts[k], ys[k], lo, hi,
                                   mask, device=img.device)
        gaps.append(max(float(np.abs(a - b).max())
                        for a, b in zip(batch[k][:2], one[:2])))
    print(f"far starts, streams from their single steps: "
          f"{[f'{g:.3g}' for g in gaps]}")
    assert max(gaps) <= 1e-2


# ---------------------------------------------------------------------------
# the mesh (parallel/): a one-card mesh repeats cuda:0, two-card meshes skip
# on one card


def _mesh_query(mesh, scene, eager=False, **kw):
    """The sharded query on descent_scene's room from a 6 x 8 grid around
    its pose, with a sharded f32 plan and HistPlan unless ``kw`` says."""
    from piccolo_tpu_torch import build_hist_plan, parallel as P

    img, xyz, rgb, mask, lo, hi, t0, _ = scene
    trans = t0.cpu().numpy()
    rot = np.stack([np.linspace(0, 6.28, 8, endpoint=False), np.zeros(8),
                    np.zeros(8)], 1).astype(np.float32)
    init = img[::2, ::2].contiguous()
    plan = P.shard_grid_plan(mesh, xyz, rgb, mask, trans, rot, 64, 128)
    hp = P.shard_hist_plan(mesh, build_hist_plan(
        xyz, rgb, trans, rot, 64, 128, point_mask=mask, device=mesh.lead))
    args = dict(num_intermediate=12, num_input=4, num_iter=40, lr=0.1,
                patience=5, factor=0.8, plan=plan, hist_plan=hp)
    args.update(kw)
    return P.localize_query_sharded(
        mesh, init, img, xyz, rgb, trans, rot, np.ones(6, bool), lo, hi,
        mask, _eager=eager, **args)


def _same_result(a, b):
    return all(torch.equal(x, y) for x, y in (
        (a.cand_t, b.cand_t), (a.cand_ypr, b.cand_ypr),
        (a.cand_loss, b.cand_loss), (a.start_t, b.start_t)))


@pytest.mark.parametrize("prune", [None, (15, 2)])
def test_one_card_mesh_graph_equals_eager(descent_scene, prune):
    """A 2 x 2 mesh whose four shards are all cuda:0: the captured shard
    and combine graphs give the eager split's bits, and every shard's
    kernels launch on card 0."""
    from piccolo_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 2, devices=["cuda:0"] * 4)
    n_slab = slab.slab_group_sums_f32.by_card.get(0, 0)
    n_bh = block_histogram.by_card.get(0, 0)
    got = _mesh_query(mesh, descent_scene, descent_prune=prune)
    want = _mesh_query(mesh, descent_scene, eager=True, descent_prune=prune)
    torch.cuda.synchronize()
    assert _same_result(got, want)
    assert slab.slab_group_sums_f32.by_card[0] > n_slab
    assert block_histogram.by_card[0] > n_bh


def test_one_card_mesh_matches_single_device(descent_scene):
    """The same query over the one-card mesh and on one device with the
    same plans, at the JAX tests' settings (tests/test_parallel.py: 5
    iterations at lr 0.1): the same starts and winner (stage 2 is exact;
    stage 1's sums add in another order), candidate losses within 1e-3."""
    from piccolo_tpu_torch import build_grid_plan, build_hist_plan
    from piccolo_tpu_torch import localize_query
    from piccolo_tpu_torch.parallel import make_mesh

    img, xyz, rgb, mask, lo, hi, t0, _ = descent_scene
    got = _mesh_query(make_mesh(2, 2, devices=["cuda:0"] * 4), descent_scene,
                      num_iter=5, lr=0.1)
    trans = t0.cpu().numpy()
    rot = np.stack([np.linspace(0, 6.28, 8, endpoint=False), np.zeros(8),
                    np.zeros(8)], 1).astype(np.float32)
    one = localize_query(
        img[::2, ::2].contiguous(), img, xyz, rgb, trans, rot,
        np.ones(6, bool), lo, hi, mask, masked=True, num_intermediate=12,
        num_input=4, num_iter=5, lr=0.1, patience=5, factor=0.8,
        plan=build_grid_plan(xyz, rgb, mask, trans, rot, 64, 128,
                             device=img.device),
        hist_plan=build_hist_plan(xyz, rgb, trans, rot, 64, 128,
                                  point_mask=mask, device=img.device),
        device=img.device)
    assert torch.equal(got.start_t, one.start_t)
    assert int(got.winner) == int(one.winner)
    assert float((got.cand_loss - one.cand_loss).abs().max()) < 1e-3


def test_two_card_mesh_equals_one_card_mesh(two_cards):
    """A 1 x 2 mesh over cuda:0 and cuda:1 gives the bits of the same mesh
    on cuda:0 alone (the same kernels on the same shapes), and its second
    shard's kernels launch on card 1."""
    from piccolo_tpu_torch.parallel import make_mesh

    scene = _descent_scene(two_cards[0])
    n1 = slab.slab_group_sums_f32.by_card.get(1, 0)
    two = _mesh_query(make_mesh(1, 2, devices=list(two_cards)), scene)
    one = _mesh_query(make_mesh(1, 2, devices=["cuda:0", "cuda:0"]), scene)
    torch.cuda.synchronize()
    assert _same_result(two, one)
    assert slab.slab_group_sums_f32.by_card[1] > n1


def test_served_query_devices_on_two_cards(two_cards):
    """query_devices = 2: requests answer on card 0 and card 1 in turn,
    with the same bits."""
    from piccolo_tpu_torch.serve import LocalizeService

    rng = np.random.default_rng(5)
    xyz, rgb = make_room(rng, n_per_wall=1500, texture="checker")
    img = render_at(xyz, rgb, np.float32([0.4, -0.2, 0.15]),
                    np.float32([0.9, 0, 0]), (128, 256), device="cpu").numpy()
    img = (img * 255).astype(np.uint8)
    svc = LocalizeService(
        query_devices=2, xy_only=True, num_trans=16, yaw_only=True,
        num_yaw=4, z_prior=None, num_split_h=4, num_split_w=4,
        num_intermediate=8, num_input=4, num_iter=60, lr=0.1, patience=5,
        factor=0.8, slab_init=True)
    svc.load_room(xyz, rgb, name="box")
    assert [c["device"] for c in svc._rooms["box"]] == list(two_cards)
    a, b = svc.localize(img), svc.localize(img)
    assert (a["device_index"], b["device_index"]) == (0, 1)
    np.testing.assert_array_equal(a["t"], b["t"])
    np.testing.assert_array_equal(a["cand_loss"], b["cand_loss"])


def test_exec_cache_builds_then_hits_on_the_card(dev, tmp_path):
    """A fresh executable-cache directory builds the five kernel libraries
    and the JPEG codec; a second warm-up loads all six."""
    from piccolo_tpu_torch.kernels import _build
    from piccolo_tpu_torch.utils import exec_cache

    store = _build.library_store()
    try:
        exec_cache.clear_memo()
        first = exec_cache.warm(tmp_path, dev)
        names = sorted(n.split("-")[0] for n in first["built"])
        assert names == ["block_histogram", "descent_step", "jpeg_codec",
                         "masked_histogram", "slab_sampling", "splat_hist"]
        assert not first["hits"]
        exec_cache.clear_memo()
        second = exec_cache.warm(tmp_path, dev)
        assert sorted(second["hits"]) == sorted(first["built"])
        assert not second["built"] and not second["rebuilt"]
    finally:
        _build.use_store(store)
        exec_cache.clear_memo()


def test_capture_under_the_profiler_gives_the_same_bits(descent_scene,
                                                        tmp_path):
    """A graph captured inside utils.maybe_trace, and a replay of it there,
    give the bits of a graph captured without the profiler."""
    from piccolo_tpu_torch import solver
    from piccolo_tpu_torch.utils import maybe_trace

    solver.clear_graphs()
    want = _descend(descent_scene, False)
    solver.clear_graphs()
    before = solver.graph_stats()["captures"]
    for _ in range(2):  # a capture, then a replay, each profiled
        with maybe_trace(str(tmp_path)):
            got = _descend(descent_scene, False)
            torch.cuda.synchronize()
        for a, b in zip(got[0].leaves(), want[0].leaves()):
            assert torch.equal(a, b)
        assert torch.equal(got[1], want[1])
    assert solver.graph_stats()["captures"] == before + 1
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 2


def test_trace_holds_its_block_after_many_sessions(dev, tmp_path):
    """Thirty traces in turn, each of one block-histogram launch: every
    trace holds that kernel's record, behind maybe_trace's warm-up."""
    import json

    from piccolo_tpu_torch.utils import maybe_trace

    rng = np.random.default_rng(3)
    ids = torch.as_tensor(rng.integers(0, 512, (8, 4096), dtype=np.int32),
                          device=dev)
    mask = torch.ones(8, 4096, device=dev)
    for k in range(30):
        with maybe_trace(str(tmp_path), name=f"b{k}"):
            block_histogram(ids, mask, 512)
    for path in tmp_path.glob("*.pt.trace.json"):
        events = json.loads(path.read_text())["traceEvents"]
        names = [e["name"] for e in events if e.get("cat") == "kernel"]
        assert sum("block_histogram_kernel" in n for n in names) == 1, path


# ---------------------------------------------------------------------------
# the descent step's kernels at the OmniScenes cell's shapes, by the checks
# of scripts/bench_descent_step.py and under its bounds


@pytest.fixture(scope="module")
def bench():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from scripts import bench_descent_step

    return bench_descent_step


@pytest.fixture(scope="module")
def cell_scene(bench):
    """240,000 points of a ray-cast checker room with two occluders, three
    dense 2048x1024 panoramas 3 cm and 0.02 rad apart, a 90% mask, the
    clamp box and the first panorama's pose."""
    return bench.scene(240_000, 1024, 2048, 3, torch.device("cuda"))


@pytest.mark.parametrize("layout", ["starts", "stacked"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_descent_kernels_match_plain(bench, cell_scene, dtype, wrap, masked,
                                     layout):
    """The pair against the plain version (``check_case``): the sums of
    every start (6 on one table, or 3 stacked streams), then one whole
    step in place and ten more, each call one launch of the pair."""
    from piccolo_tpu_torch.kernels import descent_step as K

    stacked = 3 if layout == "stacked" else 0
    n = K.descent_step.launches
    row = bench.check_case(cell_scene, dtype, wrap, masked, stacked or 6,
                           stacked)
    assert row["ok"], row
    assert K.descent_step.launches == n + 11


def test_descent_kernel_replays_are_bit_equal(bench, cell_scene):
    """Two runs of the captured step from one state: the same bits."""
    assert bench.replays(cell_scene, 6)


def test_descent_kernels_against_the_autograd_step(bench, cell_scene):
    """The cell's 6 x 100 descent at lr 0.1 on the bf16 table from starts
    up to 0.1 m and 0.15 rad off, by the kernels' graph and by the autograd
    step's eager loop.  Adam at lr 0.1 carries a change in the order of a
    sum to about a centimetre over 100 steps, and the autograd step run one
    start at a time (its batch's reduction order alone) is the witness of
    that spread.  Held (``descent``'s ``ok``): each start ends within 2x
    the witness's widest gap + 2 mm of the autograd step (at most 25 mm),
    the picked starts' losses within 10% of each other, and each picked
    start within 2 cm of the panorama's pose."""
    out = bench.descent(cell_scene, 6, 100, bench.NEAR)
    print(out)
    assert out["ok"], out


def test_descent_counts_kernel_steps(bench, cell_scene):
    """While tracing, a 6-start descent of 100 steps stores
    ``descent.steps_kernel`` 100 on its request, and nothing plain."""
    from piccolo_tpu_torch import solver
    from piccolo_tpu_torch.utils import profiling

    x, s = bench.inputs(cell_scene, "bfloat16", False, True, 0)
    t, ypr = bench.starts(cell_scene, 6, bench.NEAR)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profiling.request("service.request") as req:
            solver.descend_packed(x, s, t, ypr, 100, 0.1)
        recs = profiling.span_records(req.start)
    counts = [(r.name, r.n) for r in recs if r.name.startswith("descent.")
              and req.requests[0] in r.requests]
    assert counts == [("descent.steps_kernel", 100)]
