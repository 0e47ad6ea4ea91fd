"""The port's device rule: run on the card unless the caller asks for the CPU.

Entry points take ``device="cuda"`` by default.  Without a card they raise
instead of quietly running the plain CPU path: a CPU run of this package is
always something the caller asked for (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "on_card"]


def resolve_device(device="cuda") -> torch.device:
    """The torch device for ``device``; raises when CUDA is asked for but
    no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy array, tensor or scalar -> tensor on ``device`` (no copy when it
    is already there with that dtype)."""
    if isinstance(x, np.ndarray):
        if dtype is None and x.dtype == np.float64:
            dtype = torch.float32
        if not x.flags.writeable:  # e.g. np.asarray of a JAX array
            x = x.copy()
    return torch.as_tensor(x, dtype=dtype, device=device)


def on_card(device) -> bool:
    """Whether ``device`` (a torch.device, its name, or None) is a CUDA
    card: the values that choose the card's routes take the H100's there
    and the JAX package's elsewhere."""
    return device is not None and torch.device(device).type == "cuda"
