"""Interactive debug visualization (port of piccolo_tpu/utils/debug.py; the
reference's ``debug_visualize``, ``utils.py:641-698``): show a tensor as
image(s) with matplotlib, for (H, W), (H, W, C) and (B, H, W, C) layouts,
int [0, 255] or float [0, 1] ranges, and multi-channel slice grids.
Accepts torch tensors (any device) and numpy arrays.  matplotlib is
imported when the function is called, never with the module: a machine
without it imports the package and raises only here.
"""

from __future__ import annotations

import numpy as np

__all__ = ["debug_visualize"]


def debug_visualize(tgt, show: bool = True):
    """Visualize a tensor; returns the matplotlib figure.

    If a batch dimension exists, the first instance is shown. 3-channel
    inputs display as RGB; other channel counts as grayscale slices.
    """
    try:
        import matplotlib.pyplot as plt
    except ImportError as exc:
        raise ImportError(
            "debug_visualize draws with matplotlib, which is not installed "
            "here") from exc

    if hasattr(tgt, "detach"):  # a torch tensor
        arr = tgt.detach().cpu().numpy().astype(np.float64)
    else:
        arr = np.asarray(tgt).astype(np.float64)

    if arr.max() > 2.0:  # assume [0, 255]
        arr = arr / 255.0

    if arr.ndim == 4:
        arr = arr[0]

    fig = plt.figure()
    if arr.ndim == 2:
        plt.imshow(arr, cmap="gray", vmin=arr.min(), vmax=arr.max())
    elif arr.ndim == 3:
        C = arr.shape[-1]
        if C == 3:
            plt.imshow(np.clip(arr, 0, 1))
        elif C == 1:
            plt.imshow(arr[..., 0], cmap="gray", vmin=arr.min(), vmax=arr.max())
        else:
            plt.close(fig)
            fig = plt.figure(figsize=(10, 10))
            rows = max(C // 2, 1)
            for i in range(C):
                fig.add_subplot(rows, 2, i + 1)
                plt.imshow(
                    arr[..., i], cmap="gray",
                    vmin=arr[..., i].min(), vmax=arr[..., i].max(),
                )
    else:
        plt.close(fig)
        raise ValueError(f"unsupported shape {arr.shape}")

    if show:
        plt.show()
    return fig
