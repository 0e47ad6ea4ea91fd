"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: these need an NVIDIA GPU with nvcc and skip elsewhere.
Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``
(``tests/conftest.py`` imports jax).  Histograms are bit-exact on 0/1
masks and the same bits from run to run on any mask; slab counts are exact
and sums agree within rtol 1e-5 (the kernels add the floats in another
order than the plain versions).  The group-sum kernels of all three plan
layouts are also held on hand-built edge plans, fused and unfused.  The two
tests of launches on a card that is not the current one need two cards.
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


@pytest.mark.parametrize("B,N", [(320, 8192), (7, 3001)])
def test_block_histogram_kernel_bit_exact(dev, B, N):
    g = torch.Generator(device="cpu").manual_seed(B)
    ids = torch.randint(-3, 530, (B, N), generator=g, dtype=torch.int32)
    mask = (torch.rand((B, N), generator=g) < 0.7).to(torch.float32)
    want = block_histogram_plain(ids.to(dev), mask.to(dev))
    n0 = block_histogram.launches
    got = block_histogram(ids.to(dev), mask.to(dev))
    torch.cuda.synchronize()
    assert block_histogram.launches == n0 + 1
    assert torch.equal(got, want)


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
