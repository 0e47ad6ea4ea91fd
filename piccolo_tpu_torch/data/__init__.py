"""Dataset loaders (Stanford2D-3D-S, OmniScenes); numpy only."""

from .loader import load_txt_pointcloud, subsample
from .omniscenes import (
    obtain_gt_omniscenes,
    omniscenes_pano_glob,
    omniscenes_pcd_path,
    read_omniscenes,
)
from .stanford import (
    obtain_gt_stanford,
    read_stanford,
    stanford_pano_glob,
    stanford_pcd_path,
)

__all__ = [
    "load_txt_pointcloud",
    "subsample",
    "obtain_gt_omniscenes",
    "omniscenes_pano_glob",
    "omniscenes_pcd_path",
    "read_omniscenes",
    "obtain_gt_stanford",
    "read_stanford",
    "stanford_pano_glob",
    "stanford_pcd_path",
]
