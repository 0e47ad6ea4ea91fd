"""The block-histogram kernel's launch choice and its oracle, on the CPU.

``kernels.block_histogram.cta_threads`` chooses the threads of the CUDA
kernel's CTAs, one a row.  Checked here, without a card:
  * 256 or 512 threads, 512 exactly while the rows fit one CTA an SM, at
    the main path's four stage-2 and colour-match shapes on an H100's 132
    SMs too;
  * the wrapper's checks of its inputs, and on CPU tensors the plain
    version with no launch counted, for a view one element into its
    storage too;
  * the plain version (the kernel's oracle on the card) equals the JAX
    kernel (Pallas interpret mode) on runs of one bin and on uniform ids,
    at ragged N, with an all-masked and an all-unmasked row: integer
    counts, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piccolo_tpu.kernels.histogram_mxu import block_histogram_pallas
from piccolo_tpu_torch.kernels.block_histogram import (
    block_histogram,
    block_histogram_plain,
    cta_threads,
)

torch.set_num_threads(1)

H100_SMS = 132
# (B, N, num_bins) of the main path's calls and the threads each gets on an
# H100: library and Stanford stage 2, a 2 x 2 mesh shard's stage 2, a
# tracked frame's colour match, OmniScenes stage 2
MAIN_SHAPES = [(320, 8192, 512, 256), (128, 8192, 512, 512),
               (3072, 2048, 256, 256), (800, 131072, 512, 256)]


@pytest.mark.parametrize("sms", [16, 78, 114, 132])
def test_cta_threads(sms):
    for B in (1, 2, 7, 20, 64, 128, 131, 132, 133, 320, 800, 3072):
        T = cta_threads(B, sms)
        assert T in (256, 512)
        assert (T == 512) == (B <= sms), (B, sms, T)


@pytest.mark.parametrize("B,N,num_bins,threads", MAIN_SHAPES)
def test_main_path_threads(B, N, num_bins, threads):
    assert cta_threads(B, H100_SMS) == threads


@pytest.mark.parametrize("ids_shape,mask_shape,dtypes,error", [
    ((4, 8), (4, 9), (torch.int32, torch.float32), ValueError),
    ((32,), (32,), (torch.int32, torch.float32), ValueError),
    ((4, 8), (4, 8), (torch.int64, torch.float32), TypeError),
    ((4, 8), (4, 8), (torch.int32, torch.float64), TypeError),
])
def test_wrapper_rejects(ids_shape, mask_shape, dtypes, error):
    ids = torch.zeros(ids_shape, dtype=dtypes[0])
    mask = torch.ones(mask_shape, dtype=dtypes[1])
    with pytest.raises(error):
        block_histogram(ids, mask)


def test_wrapper_rejects_other_devices():
    ids = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="one device"):
        block_histogram(ids, torch.ones((4, 8), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        block_histogram(ids.to("meta"), torch.ones((4, 8), device="meta"))


def _inputs(B, N, num_bins, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "coherent":  # runs of one bin, as stage 2's rendered blocks
        vals = rng.integers(-3, num_bins + 18, B * N // 20 + 2)
        ids = np.resize(np.repeat(vals, rng.integers(1, 40, vals.size)),
                        B * N)
        on = rng.random(vals.size) < 0.8
        mask = np.resize(np.repeat(on, rng.integers(1, 40, vals.size)), B * N)
    else:
        ids = rng.integers(-3, num_bins + 18, B * N)
        mask = rng.random(B * N) < 0.7
    ids = ids.reshape(B, N).astype(np.int32)
    mask = mask.reshape(B, N).astype(np.float32)
    mask[0] = 0.0  # an all-masked row
    mask[1] = 1.0  # an all-unmasked row
    return ids, mask


@pytest.mark.parametrize("num_bins", [256, 512])
@pytest.mark.parametrize("N", [1, 7, 3001])
@pytest.mark.parametrize("kind", ["coherent", "uniform"])
def test_plain_matches_pallas(kind, N, num_bins):
    """The plain version equals the JAX kernel; the wrapper on CPU tensors,
    one element into their storage, gives the plain version's counts and
    launches nothing."""
    B = 4
    ids, mask = _inputs(B, N, num_bins, kind, N + num_bins)
    want = np.asarray(block_histogram_pallas(jnp.asarray(ids),
                                             jnp.asarray(mask), num_bins))
    got = block_histogram_plain(torch.tensor(ids), torch.tensor(mask),
                                num_bins)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0].sum() == 0
    assert want[1].sum() == ((ids[1] >= 0) & (ids[1] < num_bins)).sum()

    def shifted(a):
        t = torch.empty(a.size + 1, dtype=torch.from_numpy(a).dtype)[1:]
        return t.view(a.shape).copy_(torch.from_numpy(a))

    n0 = block_histogram.launches
    got_w = block_histogram(shifted(ids), shifted(mask), num_bins)
    np.testing.assert_array_equal(got_w.numpy(), want)
    assert block_histogram.launches == n0
