"""Batched masked 512-bin histograms: the stage-2 block histograms.

Port of piccolo_tpu/kernels/histogram_mxu.py::block_histogram_pallas.  The
CUDA kernel is ``csrc/block_histogram.cu``: one CTA a row, 16 B loads and
one shared-memory add an entry, in CTAs whose size comes from
:func:`cta_threads`.  :func:`block_histogram_plain` is the same function in
plain PyTorch.  The wrapper takes the plain version only for tensors on the
CPU; a CUDA tensor launches the kernel or raises, a launch the card refuses
too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import count_launch, load_library, on_device

__all__ = ["block_histogram", "block_histogram_plain", "cta_threads"]

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


def cta_threads(B: int, sms: int) -> int:
    """Threads of each of the kernel's B CTAs, one a row, on a card of
    ``sms`` SMs: 512 while the rows fit one CTA an SM (a shorter chain of
    loads a thread), else 256."""
    return 512 if B <= sms else 256


@functools.cache
def _library():
    lib = load_library("block_histogram")
    for fn, n_ptr in ((lib.block_histogram_launch, 3),
                      (lib.block_histogram_empty_launch, 0)):
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"block_histogram {what} failed: CUDA error {err}")


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
    threads = cta_threads(B, _sms(ids.device.index))
    lib = _library()
    with on_device(ids.device) as stream:
        err = lib.block_histogram_launch(ids.data_ptr(), mask.data_ptr(),
                                         out.data_ptr(), B, N, num_bins,
                                         threads, stream)
    _check(err, "launch")
    count_launch(block_histogram, ids.device)
    return out


def _empty_launch(B: int, N: int, num_bins: int, device: torch.device) -> None:
    """Launch an empty kernel with the geometry :func:`block_histogram`
    gives (B, N) on ``device``: the floor of one launch's device time.
    Counts no launch."""
    threads = cta_threads(B, _sms(device.index))
    with on_device(device) as stream:
        err = _library().block_histogram_empty_launch(B, N, num_bins,
                                                      threads, stream)
    _check(err, "empty launch")


block_histogram.launches, block_histogram.by_card = 0, {}
