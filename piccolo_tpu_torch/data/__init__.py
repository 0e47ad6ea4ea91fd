"""Dataset loaders (Stanford2D-3D-S); numpy only."""

from .loader import load_txt_pointcloud, subsample
from .stanford import (
    obtain_gt_stanford,
    read_stanford,
    stanford_pano_glob,
    stanford_pcd_path,
)

__all__ = [
    "load_txt_pointcloud",
    "subsample",
    "obtain_gt_stanford",
    "read_stanford",
    "stanford_pano_glob",
    "stanford_pcd_path",
]
