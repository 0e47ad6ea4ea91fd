"""One masked histogram of (N,) bin ids weighted by an (N,) mask.

Port of piccolo_tpu/kernels/histogram_mxu.py::histogram_pallas.  The CUDA
kernel is ``csrc/masked_histogram.cu`` (grid-stride, shared-memory bins, one
global atomic per bin); :func:`masked_histogram_counts_plain` is the same
function in plain PyTorch.  ``ops.histogram.masked_histogram(...,
use_kernel=True)`` routes through it, as ``use_pallas=True`` does in JAX.
The wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library, on_device

__all__ = ["masked_histogram_counts", "masked_histogram_counts_plain"]

_MAX_BINS = 12 * 1024  # f32 bins within the 48 KB default smem


def masked_histogram_counts_plain(ids: torch.Tensor, mask: torch.Tensor,
                                  num_bins: int = 512) -> torch.Tensor:
    """(N,) int32 ids, (N,) f32 mask -> (num_bins,) f32 sums of the mask
    per bin; ids outside [0, num_bins) are dropped."""
    ok = (ids >= 0) & (ids < num_bins)
    out = torch.zeros(num_bins, dtype=torch.float32, device=ids.device)
    out.index_add_(0, torch.where(ok, ids, 0).to(torch.int64),
                   torch.where(ok, mask, 0.0))
    return out


@functools.cache
def _launcher():
    fn = load_library("masked_histogram").masked_histogram_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def masked_histogram_counts(ids: torch.Tensor, mask: torch.Tensor,
                            num_bins: int = 512) -> torch.Tensor:
    """Kernel wrapper of :func:`masked_histogram_counts_plain`."""
    if ids.dim() != 1 or mask.shape != ids.shape:
        raise ValueError(f"ids {tuple(ids.shape)} and mask "
                         f"{tuple(mask.shape)} must be the same (N,)")
    if ids.dtype != torch.int32 or mask.dtype != torch.float32:
        raise TypeError(f"need int32 ids and f32 mask, got {ids.dtype} "
                        f"and {mask.dtype}")
    if ids.device != mask.device:
        raise ValueError("ids and mask must be on one device")
    if ids.device.type == "cpu":
        return masked_histogram_counts_plain(ids, mask, num_bins)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    if not (ids.is_contiguous() and mask.is_contiguous()):
        raise ValueError("ids and mask must be contiguous")
    if not 0 < num_bins <= _MAX_BINS:
        raise ValueError(f"num_bins must be in (0, {_MAX_BINS}]")
    out = torch.zeros(num_bins, dtype=torch.float32, device=ids.device)
    if ids.numel() == 0:
        return out
    launch = _launcher()
    with on_device(ids.device) as stream:
        err = launch(ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
                     ids.numel(), num_bins, stream)
    if err != 0:
        raise RuntimeError(f"masked_histogram launch failed: CUDA error {err}")
    masked_histogram_counts.launches += 1
    return out


masked_histogram_counts.launches = 0
