"""OmniScenes dataset: cloud loading and GT pose files (a copy of
piccolo_tpu/data/omniscenes.py).

Behavioural parity with the reference (``data_utils.py:138-182``): clouds
are ``x y z r g b`` text files; the GT ``[R|t]`` 3x4 matrix lives in a .txt
found by substituting ``pano -> pose`` and ``.jpg -> .txt`` in the pano
path.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .loader import load_txt_pointcloud

__all__ = ["read_omniscenes", "obtain_gt_omniscenes", "omniscenes_pcd_path",
           "omniscenes_pano_glob"]


def read_omniscenes(filepath: str, sample_rate: float = 1.0):
    """(N,3) xyz + (N,3) rgb in [0,1]."""
    return load_txt_pointcloud(filepath, sample_rate)


def omniscenes_pcd_path(data_root: str, room_type: str, room_no: str) -> str:
    return os.path.join(data_root, "omniscenes", "pcd", f"{room_type}_{room_no}.txt")


def omniscenes_pano_glob(data_root: str, split_name: str = "extreme") -> str:
    return os.path.join(data_root, "omniscenes", f"{split_name}_pano", "*", "*")


def obtain_gt_omniscenes(full_img_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """GT (trans (3,1), rot (3,3)) from the pose txt next to the pano."""
    pose_file = full_img_path.replace("pano", "pose").replace(".jpg", ".txt")
    gt = np.loadtxt(pose_file)
    return gt[:, 3:], gt[:, :3]
