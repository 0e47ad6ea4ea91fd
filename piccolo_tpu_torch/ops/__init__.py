"""Geometry and imaging ops (port of piccolo_tpu.ops), under the JAX
package's names."""

from .histogram import (
    bin_ids,
    block_histograms,
    histogram_intersection,
    masked_histogram,
)
from .pano import render_pano
from .projection import safe_norm, spherical_project
from .quantile import cloud_bounds, order_quantile, out_of_room, pose_search_bounds
from .rotation import rot_from_ypr, rot_x, rot_y, rot_z
from .sampling import bilinear_sample
from .warp import warp_from_img

__all__ = [
    "bin_ids",
    "block_histograms",
    "histogram_intersection",
    "masked_histogram",
    "render_pano",
    "safe_norm",
    "spherical_project",
    "cloud_bounds",
    "order_quantile",
    "out_of_room",
    "rot_from_ypr",
    "rot_x",
    "rot_y",
    "rot_z",
    "bilinear_sample",
    "pose_search_bounds",
    "warp_from_img",
]
