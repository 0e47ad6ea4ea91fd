"""piccolo_tpu_torch: the PyTorch/CUDA port of piccolo_tpu for NVIDIA Hopper.

The fused per-query localization (``localize_query``) with its room-static
plans (``build_grid_plan``, ``build_hist_plan``).  Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``; the two
stage-1/stage-2 kernels are hand-written CUDA built with nvcc at first use.
This package imports torch and numpy only, never JAX or piccolo_tpu.
"""

from .init.refine import HistPlan, build_hist_plan
from .kernels.slab_sampling import GridPlan, build_grid_plan
from .pipeline import LocalizeResult, localize_query

__all__ = [
    "GridPlan",
    "HistPlan",
    "LocalizeResult",
    "build_grid_plan",
    "build_hist_plan",
    "localize_query",
]
