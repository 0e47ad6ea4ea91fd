"""The card's peaks and the work each stage of a query needs.

The peaks are the H100 SXM data sheet's (dense, no sparsity): 3.35 TB/s of
HBM and 67 TFLOP/s of float32 outside the tensor cores (the constants of
``chip_smoke.py``).  A stage's least time is the larger of its bytes over
the bandwidth and its float32 operations over the peak.  The work is what
the stage's inputs need, counted from the cell's shapes and never from
kernel names: each input byte read once, each output byte written once,
and the operations of PICCOLO's formulas.  So a fused kernel or a new path
is judged against the same work as the kernels it replaces.

Operations counted (one for each add, multiply, compare, floor, square
root or arctangent):

* a pose applied to a point and projected: 3 subtracts and 9 multiply-adds
  (21), the xy norm (4), two arctangents and their offsets (4), u and v
  (6): 35;
* a bilinear colour sample and its distance: four weights (6), the clip and
  pixel transform (8), three channels of four taps (24), the black test,
  the difference, its squares and their sum, the square root and the
  masked add (12): 50 (``chip_smoke.py``'s sample count, 42, with the
  clip and the pixel transform that its plan had made beforehand);
* a splat: the point's distance (6) and pixel (6), nine taps of a clamp
  and a min (27): 39 a point and pose; a pixel's bin test and count: 3;
* a descent step: the loss's forward (85 a point) and its gradient (two
  forward's worth, 170), 255 a point, start and iteration.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

PROJECT_OPS = 35
SAMPLE_OPS = 50
SPLAT_POINT_OPS = 39
HIST_PIXEL_OPS = 3
HIST_BINS = 512
DESCENT_POINT_OPS = 3 * (PROJECT_OPS + SAMPLE_OPS)


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def stage1(pairs: int, points: int, init_hw) -> float:
    """Least seconds of stage 1: every pair's loss over every point."""
    h, w = init_hw
    nbytes = points * 24 + pairs * 24 + h * w * 12 + pairs * 4
    ops = pairs * points * (PROJECT_OPS + SAMPLE_OPS)
    return least_seconds(nbytes, ops)


def stage2(candidates: int, points: int, init_hw, blocks: int) -> float:
    """Least seconds of stage 2: a splat and block histograms a candidate,
    intersected with the query's."""
    h, w = init_hw
    nbytes = points * 24 + h * w * 12 + candidates * 28 + candidates * 4
    ops = candidates * (points * (PROJECT_OPS + SPLAT_POINT_OPS)
                        + h * w * HIST_PIXEL_OPS + blocks * HIST_BINS * 3)
    return least_seconds(nbytes, ops)


def descent(starts: int, iterations: int, points: int, main_hw) -> float:
    """Least seconds of stage 3: every start's steps over every point."""
    h, w = main_hw
    nbytes = points * 24 + h * w * 12 + starts * 28 * 2
    ops = starts * iterations * points * DESCENT_POINT_OPS
    return least_seconds(nbytes, ops)
