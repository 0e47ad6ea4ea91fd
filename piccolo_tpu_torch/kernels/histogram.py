"""One masked histogram of (N,) bin ids weighted by an (N,) mask.

Port of piccolo_tpu/kernels/histogram_mxu.py::histogram_pallas.  The CUDA
kernel is ``csrc/masked_histogram.cu`` (16 B loads, warp-owned bins in
shared memory added in lane order, per-CTA partials added in a fixed order
by a second launch: no float atomics, the same bits on every run);
:func:`masked_histogram_counts_plain` is the same function in plain
PyTorch.  ``ops.histogram.masked_histogram(..., use_kernel=True)`` routes
through it, as ``use_pallas=True`` does in JAX.
The wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library, on_device

__all__ = ["masked_histogram_counts", "masked_histogram_counts_plain"]

_MAX_BINS = 12 * 1024  # 96 KB of bins and tags: two warps' fit a CTA
# entries a CTA covers, at least (wider histograms give each CTA more, so
# that zeroing and adding its bins stays a small share of its work)
_ENTRIES_PER_CTA = 2048


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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _max_ctas(device_index: int, num_bins: int) -> int:
    """CTAs of the histogram kernel that the card holds at once."""
    fn = load_library("masked_histogram").masked_histogram_max_ctas
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    ctas = ctypes.c_int(0)
    with on_device(torch.device("cuda", device_index)):
        err = fn(num_bins, ctypes.byref(ctas))
    if err != 0 or ctas.value == 0:
        raise RuntimeError(f"masked histogram: no CTA of {num_bins} bins fits "
                           f"this card (CUDA error {err})")
    return ctas.value


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
    n = ids.numel()
    if n >= 2**31:
        raise ValueError(f"at most 2**31 - 1 entries, got {n}")
    if n == 0:
        return torch.zeros(num_bins, dtype=torch.float32, device=ids.device)
    per_cta = max(_ENTRIES_PER_CTA, 8 * num_bins)
    n_cta = max(1, min(-(-n // per_cta), _max_ctas(ids.device.index,
                                                    num_bins)))
    partials = torch.empty((n_cta, num_bins), dtype=torch.float32,
                           device=ids.device)
    out = torch.empty(num_bins, dtype=torch.float32, device=ids.device)
    launch = _launcher()
    with on_device(ids.device) as stream:
        err = launch(ids.data_ptr(), mask.data_ptr(), partials.data_ptr(),
                     out.data_ptr(), n, num_bins, n_cta, stream)
    if err != 0:
        raise RuntimeError(f"masked_histogram launch failed: CUDA error {err}")
    masked_histogram_counts.launches += 1
    return out


masked_histogram_counts.launches = 0
