"""Batched masked 512-bin histograms: the stage-2 block histograms.

Port of piccolo_tpu/kernels/histogram_mxu.py::block_histogram_pallas.  The
CUDA kernel is ``csrc/block_histogram.cu`` (one CUDA block per row, shared
memory integer counters); :func:`block_histogram_plain` is the same function
in plain PyTorch.  The wrapper takes the plain version only for tensors on
the CPU; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library, on_device

__all__ = ["block_histogram", "block_histogram_plain"]

_MAX_BINS = 12 * 1024  # int32 counters within the 48 KB default smem


def block_histogram_plain(ids: torch.Tensor, mask: torch.Tensor,
                          num_bins: int = 512) -> torch.Tensor:
    """(B, N) int32 ids, (B, N) f32 mask -> (B, num_bins) f32 counts of the
    entries with mask != 0 and an id in [0, num_bins)."""
    B = ids.shape[0]
    ok = (mask != 0) & (ids >= 0) & (ids < num_bins)
    row = torch.arange(B, device=ids.device)[:, None] * num_bins
    flat = (row + ids.clamp(0, num_bins - 1)).reshape(-1)
    out = torch.zeros(B * num_bins, dtype=torch.float32, device=ids.device)
    out.index_add_(0, flat, ok.reshape(-1).to(torch.float32))
    return out.reshape(B, num_bins)


@functools.cache
def _launcher():
    fn = load_library("block_histogram").block_histogram_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def block_histogram(ids: torch.Tensor, mask: torch.Tensor,
                    num_bins: int = 512) -> torch.Tensor:
    """Masked histogram of each row; see :func:`block_histogram_plain`."""
    if ids.dim() != 2 or mask.shape != ids.shape:
        raise ValueError(f"ids {tuple(ids.shape)} and mask "
                         f"{tuple(mask.shape)} must be the same (B, N)")
    if ids.dtype != torch.int32 or mask.dtype != torch.float32:
        raise TypeError(f"need int32 ids and f32 mask, got {ids.dtype} "
                        f"and {mask.dtype}")
    if ids.device != mask.device:
        raise ValueError("ids and mask must be on one device")
    if ids.device.type == "cpu":
        return block_histogram_plain(ids, mask, num_bins)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    if not (ids.is_contiguous() and mask.is_contiguous()):
        raise ValueError("ids and mask must be contiguous")
    if not 0 < num_bins <= _MAX_BINS:
        raise ValueError(f"num_bins must be in (0, {_MAX_BINS}]")
    B, N = ids.shape
    out = torch.empty((B, num_bins), dtype=torch.float32, device=ids.device)
    if B == 0:
        return out
    launch = _launcher()
    with on_device(ids.device) as stream:
        err = launch(ids.data_ptr(), mask.data_ptr(), out.data_ptr(), B, N,
                     num_bins, stream)
    if err != 0:
        raise RuntimeError(f"block_histogram launch failed: CUDA error {err}")
    block_histogram.launches += 1
    return out


block_histogram.launches = 0
