"""Stage 2's live-splat block counts (``kernels/splat_hist.py``).

On the CPU: the wrapper's plain version equals the path the port took
before it (the splat's winner bins from ``ops/pano.py``, laid out by block
and counted by ``block_histogram_plain``), and ``hist_scores_core`` keeps
its scores bit for bit; the counter names the route; the card's input
checks.  Marked ``cuda`` (skip without a card; on the card run
``python -m pytest --noconftest tests/test_torch_splat_hist.py -m cuda``):
the kernel pair's counts equal the plain version's on the card bit for bit
at the OmniScenes cell's shapes, on odd shapes whose blocks do not divide
the image, on points that land on the first and last rows and columns,
with black points and a point mask, where no point counts, and at
Stanford's 4096x2048 block shape.
"""

import time

import numpy as np
import pytest
import torch

from piccolo_tpu_torch.init import refine
from piccolo_tpu_torch.kernels import splat_hist as K
from piccolo_tpu_torch.kernels.block_histogram import block_histogram_plain
from piccolo_tpu_torch.loss import Pose, transform_cloud
from piccolo_tpu_torch.ops.pano import attr_min_decode, attr_min_keys
from piccolo_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _cloud(n, k, seed, dev="cpu", black=0.05, border=False):
    """n points in a 6 x 4 x 3 m box around the origin with random colours
    (a share ``black`` pure black), k poses within 1 m of the origin and
    any yaw; with ``border`` the first pose is the identity at the origin
    and the cloud also holds points on the seam (y = +-0 behind the
    camera) and at both poles, which land on the image's first and last
    columns and rows."""
    rng = np.random.default_rng(seed)
    xyz = (rng.uniform(-1, 1, (n, 3)) * [3.0, 2.0, 1.5]).astype(np.float32)
    if border:
        z = np.linspace(-1.4, 1.4, 8, dtype=np.float32)
        seam = np.stack([np.full(16, -1.5, np.float32),
                         np.repeat(np.float32([0.0, -0.0]), 8),
                         np.tile(z, 2)], 1)
        poles = np.float32([[0, 0, 1.2], [0, 0, -1.2], [0, 0, 0.3],
                            [0, 0, -0.3]])
        xyz = np.concatenate([xyz, seam, poles])
    n = xyz.shape[0]
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rgb[rng.random(n) < black] = 0.0
    trans = rng.uniform(-1, 1, (k, 3)).astype(np.float32)
    ypr = np.zeros((k, 3), np.float32)
    ypr[:, 0] = rng.uniform(-np.pi, np.pi, k)
    ypr[:, 1:] = rng.uniform(-0.1, 0.1, (k, 2))
    if border:
        trans[0] = 0.0
        ypr[0] = 0.0
    mask = rng.random(n) < 0.8
    return {name: torch.as_tensor(a, device=dev) for name, a in dict(
        xyz=xyz, rgb=rgb, trans=trans, ypr=ypr, mask=mask).items()}


def _img(H, W, seed, dev="cpu"):
    """A query panorama in [0, 1], about a tenth of its pixels black."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    img[rng.random((H, W)) < 0.1] = 0.0
    return torch.as_tensor(img, device=dev)


def _old_counts(xyz, bins, trans, ypr, pm, pix_ok, H, W, sh, sw):
    """The counts as the port computed them before the kernel pair: the
    splat's winner bins, the block layout, the plain block histogram."""
    k = trans.shape[0]
    pose = Pose(t=trans, yaw=ypr[:, 0], pitch=ypr[:, 1], roll=ypr[:, 2])
    pbin = attr_min_decode(
        attr_min_keys(transform_cloud(pose, xyz), bins, 10, (H, W), pm), 10)
    bh, bw = H // sh, W // sw

    def layout(flat):
        return (flat.reshape(k, H, W)[:, :sh * bh, :sw * bw]
                .reshape(k, sh, bh, sw, bw).permute(0, 1, 3, 2, 4)
                .reshape(k * sh * sw, bh * bw).contiguous())

    valid = (pbin >= 0) & (pbin < 512) & pix_ok
    ph = block_histogram_plain(layout(pbin.clamp(0, 511).to(torch.int32)),
                               layout(valid.to(torch.float32)), 512)
    return ph.reshape(k, sh * sw, 512)


def _old_scores(img, c, sh, sw, masked=True):
    """hist_scores_core as it was: one splat of every candidate, then the
    intersection with the query's block histograms."""
    H, W, _ = img.shape
    q = refine._query_side(img, sh, sw)
    bins = refine._point_bins(c["rgb"], 512)
    ph = _old_counts(c["xyz"], bins, c["trans"], c["ypr"],
                     c["mask"] if masked else None, q.pix_ok, H, W, sh, sw)
    pc = ph.sum(-1)
    phn = ph / pc.clamp_min(1e-12)[..., None]
    inter = torch.minimum(phn, q.img_hn).sum(-1)
    ok = (pc > 0) & (q.img_c > 0) & q.middle
    return (inter * ok).sum(-1) / q.n_blocks


def _args(c, img, sh, sw, chunk, masked=True):
    H, W, _ = img.shape
    q = refine._query_side(img, sh, sw)
    return (c["xyz"], refine._point_bins(c["rgb"], 512), c["trans"],
            c["ypr"], c["mask"] if masked else None, q.pix_ok, H, W, sh, sw,
            chunk)


# (H, W, sh, sw, chunk, masked): blocks that divide the image, blocks that
# do not, a chunk that does not divide the candidates, one block, and a
# one-pixel-wide block column
CPU_CASES = [(16, 32, 4, 4, 4, True), (19, 37, 3, 5, 4, True),
             (16, 32, 4, 4, 3, False), (12, 20, 1, 1, 8, True),
             (10, 9, 2, 9, 2, True), (24, 48, 5, 7, 1, False)]


@pytest.mark.parametrize("H,W,sh,sw,chunk,masked", CPU_CASES)
def test_plain_counts_are_the_old_path(H, W, sh, sw, chunk, masked):
    c = _cloud(2500, 7, H * W + sh, border=True)
    img = _img(H, W, sw)
    args = _args(c, img, sh, sw, chunk, masked)
    got = K.splat_block_counts(*args)
    assert got.shape == (7, sh * sw, 512)
    want = _old_counts(*args[:-1])
    assert torch.equal(got, want)
    assert torch.equal(K.splat_block_counts_plain(*args), want)
    assert float(got.sum()) > 0


@pytest.mark.parametrize("masked", [True, False])
def test_hist_scores_core_keeps_its_scores(masked):
    c = _cloud(3000, 10, 4, border=True)
    img = _img(24, 48, 5)
    got = refine.hist_scores_core(img, c["xyz"], c["rgb"], c["trans"],
                                  c["ypr"], c["mask"] if masked else None,
                                  4, 4, 4)
    assert torch.equal(got, _old_scores(img, c, 4, 4, masked))


def test_block_rows_layout():
    """Pixel (r, c) lands in block (r // bh) * sw + c // bw at (r % bh) *
    bw + c % bw; pixels outside the grid are dropped."""
    H, W, sh, sw = 7, 11, 2, 3
    flat = torch.arange(H * W)[None].repeat(2, 1)
    rows = K.block_rows(flat, H, W, sh, sw)
    bh, bw = H // sh, W // sw
    assert rows.shape == (2, sh * sw, bh * bw)
    for r in range(sh * bh):
        for col in range(sw * bw):
            b = (r // bh) * sw + col // bw
            assert int(rows[1, b, (r % bh) * bw + col % bw]) == r * W + col


def test_counter_names_the_route():
    """While a profiler session records, each call counts its candidates
    as ``stage2.splat_plain`` on the CPU."""
    c = _cloud(500, 6, 9)
    img = _img(12, 24, 9)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.time_ns()
        refine.hist_scores_core(img, c["xyz"], c["rgb"], c["trans"],
                                c["ypr"], c["mask"], 4, 4, 4)
    recs = [r for r in profiling.span_records(t0)
            if r.name.startswith("stage2.splat_")]
    assert [(r.name, r.n) for r in recs] == [("stage2.splat_plain", 6)]


def _refused(c, img, **change):
    args = dict(zip(("xyz", "bins", "trans", "ypr", "point_mask", "pix_ok",
                     "height", "width", "sh", "sw", "chunk"),
                    _args(c, img, 4, 4, 4)))
    args.update(change)
    return args


@pytest.mark.parametrize("change", ["bins_int64", "mask_uint8", "pix_ok_short",
                                    "trans_f64", "grid_too_fine", "chunk_0"])
def test_card_inputs_are_checked(change):
    """What the kernels do not take raises before a launch (the checks run
    on CPU tensors here)."""
    c = _cloud(300, 5, 2)
    img = _img(16, 32, 2)
    a = _refused(c, img)
    bad = {"bins_int64": dict(bins=a["bins"].to(torch.int64)),
           "mask_uint8": dict(point_mask=a["point_mask"].to(torch.uint8)),
           "pix_ok_short": dict(pix_ok=a["pix_ok"][1:]),
           "trans_f64": dict(trans=a["trans"].double()),
           "grid_too_fine": dict(sh=17),
           "chunk_0": dict(chunk=0)}[change]
    with pytest.raises(ValueError):
        K._check_inputs(**_refused(c, img, **bad))
    K._check_inputs(**a)  # the unchanged inputs pass


# ---------------------------------------------------------------------------
# on the card: the kernel pair against the plain version


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bench():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from scripts import bench_splat_hist

    return bench_splat_hist


def _equal_on_card(args, dev):
    n0 = K.splat_block_counts.launches
    got = K.splat_block_counts(*args)
    want = K.splat_block_counts_plain(*args)
    torch.cuda.synchronize()
    assert K.splat_block_counts.launches == n0 + 1
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert int((got != want).sum()) == 0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
def test_kernel_counts_at_the_cell_shapes(bench, masked):
    """240,000 points, 2048x1024, 56 candidates, 4 x 4 blocks, chunks of 4:
    counts, scores and the top 6 as the plain version's."""
    sc = bench.scene(240_000, 1024, 2048, 56, torch.device("cuda"))
    row = bench.check(sc, 4, 4, 4, masked)
    assert row["ok"] and row["top6_equal"] and row["counted"] > 0, row


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,sh,sw,chunk,masked", CPU_CASES + [
    (33, 65, 4, 4, 4, True), (37, 61, 3, 5, 5, False)])
def test_kernel_counts_on_odd_shapes_and_borders(dev, H, W, sh, sw, chunk,
                                                masked):
    """Blocks that do not divide the image, and the seam and pole points
    on its first and last columns and rows (clamped, no wrap)."""
    c = _cloud(4000, 9, H * W + sh, dev, black=0.1, border=True)
    got = _equal_on_card(_args(c, _img(H, W, sw, dev), sh, sw, chunk,
                               masked), dev)
    assert float(got.sum()) > 0


@pytest.mark.cuda
def test_kernel_black_points_only(dev):
    """Every point black (the sentinel bin 512): nothing counts."""
    c = _cloud(3000, 4, 1, dev, black=1.0)
    got = _equal_on_card(_args(c, _img(32, 64, 1, dev), 4, 4, 4), dev)
    assert float(got.sum()) == 0


@pytest.mark.cuda
def test_kernel_where_no_point_counts(dev):
    """A mask that keeps no point, and a query with no nonzero pixel: every
    count 0, and the scores those of the plain version."""
    c = _cloud(3000, 8, 3, dev)
    c["mask"] = torch.zeros_like(c["mask"])
    img = _img(32, 64, 3, dev)
    got = _equal_on_card(_args(c, img, 4, 4, 4), dev)
    assert float(got.sum()) == 0
    got = _equal_on_card(_args(_cloud(3000, 8, 3, dev),
                               torch.zeros_like(img), 4, 4, 4), dev)
    assert float(got.sum()) == 0
    s = refine.hist_scores_core(img, c["xyz"], c["rgb"], c["trans"],
                                c["ypr"], c["mask"], 4, 4, 4)
    assert torch.equal(s, refine._score_from_counts(
        torch.zeros_like(got), refine._query_side(img, 4, 4)))


@pytest.mark.cuda
def test_kernel_counts_at_stanford_block_shape(dev):
    """4096x2048 in 4 x 4 blocks of 1024 x 512 pixels."""
    c = _cloud(240_000, 8, 6, dev)
    _equal_on_card(_args(c, _img(2048, 4096, 6, dev), 4, 4, 4), dev)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    """int64 bins on the card raise and count no launch."""
    c = _cloud(300, 4, 2, dev)
    args = list(_args(c, _img(16, 32, 2, dev), 4, 4, 4))
    args[1] = args[1].to(torch.int64)
    n0 = K.splat_block_counts.launches
    with pytest.raises(ValueError):
        K.splat_block_counts(*args)
    assert K.splat_block_counts.launches == n0


@pytest.mark.cuda
def test_card_counter_names_the_kernel(dev):
    c = _cloud(2000, 6, 9, dev)
    img = _img(32, 64, 9, dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.time_ns()
        refine.hist_scores_core(img, c["xyz"], c["rgb"], c["trans"],
                                c["ypr"], c["mask"], 4, 4, 4)
    recs = [r for r in profiling.span_records(t0)
            if r.name.startswith("stage2.splat_")]
    assert [(r.name, r.n) for r in recs] == [("stage2.splat_kernel", 6)]
