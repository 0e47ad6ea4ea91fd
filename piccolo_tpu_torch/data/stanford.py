"""Stanford2D-3D-S dataset: cloud loading and GT pose conventions (a copy
of piccolo_tpu/data/stanford.py).

Behavioural parity with the reference data layer (``data_utils.py:16-135``).
The GT rotation convention is pure bookkeeping and copied exactly as math
(axis permutation, inversion, z-flip, and the area>10 room-alignment
branch) — it is trivially easy to get wrong and gates every accuracy number.
"""

from __future__ import annotations

import json
import os
from typing import Tuple, Union

import numpy as np
from scipy.spatial.transform import Rotation

from .loader import load_txt_pointcloud

__all__ = ["read_stanford", "obtain_gt_stanford", "stanford_pcd_path", "stanford_pano_glob"]


def read_stanford(filepath: str, sample_rate: float = 1.0):
    """(N,3) xyz + (N,3) rgb in [0,1] from an ``x y z r g b`` text file."""
    return load_txt_pointcloud(filepath, sample_rate)


def stanford_pcd_path(data_root: str, area_num: int, room_type: str, room_no: str) -> str:
    return os.path.join(
        data_root, "stanford", "pcd_not_aligned",
        f"area_{area_num}", f"{room_type}_{room_no}.txt",
    )


def stanford_pano_glob(data_root: str, area_num=None) -> str:
    if area_num is None:
        return os.path.join(data_root, "stanford", "pano", "area_*", "*.png")
    return os.path.join(data_root, "stanford", "pano", f"area_{area_num}", "*.png")


def _pose_json_rotation(cam_rot) -> np.ndarray:
    """Pose-JSON euler -> the dataset's camera rotation convention.

    The pano pose files store an xyz-euler 'final_camera_rotation'; the
    camera matrix used by the dataset permutes columns (z,x,y) and inverts
    (reference data_utils.py:78-86).
    """
    r = Rotation.from_euler("xyz", cam_rot).as_matrix()
    rot = np.zeros((3, 3))
    rot[:, 0] = r[:, 2]
    rot[:, 1] = r[:, 0]
    rot[:, 2] = r[:, 1]
    return np.linalg.inv(rot)


_FLIP_Z = np.array([[-1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]])


def obtain_gt_stanford(
    data_root: str, area_num: Union[int, str], img_name: str
) -> Tuple[np.ndarray, np.ndarray]:
    """GT (trans (3,1), rot (3,3)) for a pano image.

    Areas < 10: pose straight from the pano pose JSON, rotated 180 deg about
    z (reference data_utils.py:59-90).  Areas >= 10 (the re-aligned variants,
    e.g. area 35 = area 3 with a room alignment transform): the alignment
    matrix from ``pose/area_{A}/{room}.txt`` is composed in
    (data_utils.py:92-134).
    """
    area_num = int(area_num)
    splits = img_name.split("_")
    camera_id, room_type, room_id = splits[1], splits[2], splits[3]

    if area_num < 10:
        pose_path = os.path.join(
            data_root, "stanford", "pose", f"area_{area_num}",
            f"camera_{camera_id}_{room_type}_{room_id}_frame_equirectangular_domain_pose.json",
        )
        with open(pose_path) as f:
            pose = json.load(f)
        gt_trans = np.array(pose["camera_location"], dtype=np.float64).reshape(3, 1)
        rot = _pose_json_rotation(pose["final_camera_rotation"])
        gt_rot = _FLIP_Z @ rot
        return gt_trans, gt_rot

    # area >= 10: base area is area_num // 10, plus a room alignment
    base_area = area_num // 10
    align_path = os.path.join(
        data_root, "stanford", "pose", f"area_{area_num}",
        f"{room_type}_{room_id}.txt",
    )
    pose_path = os.path.join(
        data_root, "stanford", "pose", f"area_{base_area}",
        f"camera_{camera_id}_{room_type}_{room_id}_frame_equirectangular_domain_pose.json",
    )
    with open(pose_path) as f:
        pose = json.load(f)
    gt_trans = np.array(pose["camera_location"], dtype=np.float64).reshape(3, 1)
    rot = _pose_json_rotation(pose["final_camera_rotation"])

    align = np.loadtxt(align_path)
    align_rot = align[:, :3]
    align_trans = align[:, 3:]

    gt_rot = _FLIP_Z @ (rot @ np.linalg.inv(align_rot))
    gt_trans = align_rot @ (gt_trans - align_trans)
    return gt_trans, gt_rot
