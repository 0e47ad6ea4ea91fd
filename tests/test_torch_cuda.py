"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: these need an NVIDIA GPU with nvcc and skip elsewhere.
Run them on the card with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Block histograms are bit-exact; slab counts are exact and sums agree within
rtol 1e-5 (the kernel adds floats with atomics, in no fixed order).
"""

import numpy as np
import pytest
import torch

from piccolo_tpu_torch.kernels.block_histogram import (
    block_histogram,
    block_histogram_plain,
)
from piccolo_tpu_torch.kernels import slab_sampling as slab
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
    rng = np.random.default_rng(3)
    xyz, rgb = make_room(rng, n_per_wall=700)
    img = render_at(xyz, rgb, np.zeros(3, np.float32),
                    np.array([0.4, 0.1, 0.0], np.float32), (64, 128), device=dev)
    trans = rng.uniform(-1.0, 1.0, (5, 3)).astype(np.float32)
    rot = np.stack([np.linspace(0, 6.28, 8, endpoint=False), np.zeros(8),
                    np.zeros(8)], 1).astype(np.float32)
    plan = slab.build_grid_plan(xyz, rgb, None, trans, rot, 64, 128, device=dev)
    table = slab.slab_table(img, window=plan.window)
    for f, w in zip(plan.fields, plan.windows):
        want = slab.slab_block_partials_plain(table, f, w, plan.window)
        got = slab.slab_block_partials(table, f, w, plan.window)
        torch.cuda.synchronize()
        assert torch.equal(got[:, 1], want[:, 1])
        torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-5, atol=1e-6)
