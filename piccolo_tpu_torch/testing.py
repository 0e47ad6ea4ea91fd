"""Synthetic scenes (port of piccolo_tpu.testing's room factory and its
ray-cast oracle) and writers of synthetic Stanford2D-3D-S and OmniScenes
trees.

Render a panorama from a synthetic coloured cloud at a known pose, then
require the pipeline to recover that pose.  The scene factories are numpy
and draw exactly the JAX package's numbers from the same generator.  The
ray-cast oracle (:func:`raycast_pano`) renders dense camera-like panoramas
of the same textured surfaces the cloud samples, so colour preprocessing
(``sharpen_color``) behaves as on real captures.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from .device import as_tensor, resolve_device
from .loss import Pose, transform_cloud
from .ops.pano import render_pano
from .ops.rotation import rot_from_ypr

__all__ = ["make_room", "make_cluttered_room", "random_pose_inside",
           "pose_outside_occluders", "render_at", "RoomScene",
           "make_scene", "scene_pose", "scene_cloud", "raycast_pano",
           "IMAGE_REALISM_ARMS", "CLOUD_REALISM_ARMS", "apply_image_realism",
           "apply_cloud_realism", "REALISM_DEFAULTS", "write_synth_stanford",
           "write_synth_omniscenes", "edge_plan_group"]

_WALL_FACES = ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1))


def _other_dims(axis: int) -> Tuple[int, int]:
    d = [i for i in range(3) if i != axis]
    return d[0], d[1]


def _wall_color(u, v, axis: int, sign: int, texture: str) -> np.ndarray:
    """Wall texture as a function of normalised surface coords."""
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    base = np.zeros(3, np.float32)
    base[axis] = 0.75 if sign > 0 else 0.25
    c = base + 0.5 * np.stack([u, v, u * v], -1)
    if texture == "checker":
        checker = ((u * 6).astype(int) + (v * 6).astype(int)) % 2
        c = c * (0.6 + 0.4 * checker[..., None])
    return np.clip(c, 0.05, 1.0).astype(np.float32)


def _occluder_color(p: np.ndarray, axis: int, hue: np.ndarray) -> np.ndarray:
    """Occluder-face texture as a pure function of world position.

    Same functional form as :func:`make_cluttered_room`'s face colors
    (striped sinusoid over the two in-face world coords).
    """
    d0, d1 = _other_dims(axis)
    c = (
        hue.astype(np.float32)
        + 0.25 * np.sin(12.0 * np.asarray(p[..., d0], np.float32))[..., None]
        + 0.15 * np.asarray(p[..., d1], np.float32)[..., None]
    )
    return np.clip(c, 0.05, 1.0).astype(np.float32)


def make_room(rng: np.random.Generator, n_per_wall: int = 4000,
              size: Tuple[float, float, float] = (6.0, 4.0, 3.0),
              texture: str = "gradient") -> Tuple[np.ndarray, np.ndarray]:
    """A coloured box room: (xyz (6*n_per_wall, 3), rgb in [0, 1]) f32."""
    pts, cols = [], []
    for axis, sign in _WALL_FACES:
        uv = rng.random((n_per_wall, 2)).astype(np.float32)
        p = np.empty((n_per_wall, 3), np.float32)
        dims = [d for d in range(3) if d != axis]
        p[:, dims[0]] = (uv[:, 0] - 0.5) * size[dims[0]]
        p[:, dims[1]] = (uv[:, 1] - 0.5) * size[dims[1]]
        p[:, axis] = sign * size[axis] / 2
        pts.append(p)
        cols.append(_wall_color(uv[:, 0], uv[:, 1], axis, sign, texture))
    return np.concatenate(pts), np.concatenate(cols)


def make_cluttered_room(
    rng: np.random.Generator,
    n_per_wall: int = 4000,
    size: Tuple[float, float, float] = (6.0, 4.0, 3.0),
    n_occluders: int = 3,
    n_per_occluder: int = 2000,
    texture: str = "checker",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A box room with coloured box occluders standing inside it: real
    occlusion and parallax.  Returns (xyz, rgb, occluders), occluders a
    (K, 2, 3) array of axis-aligned (lo, hi) corners."""
    xyz, rgb = make_room(rng, n_per_wall=n_per_wall, size=size, texture=texture)
    pts, cols, boxes = [xyz], [rgb], []
    half = np.array(size, np.float32) / 2
    for k in range(n_occluders):
        dims = (0.3 + rng.random(3) * np.array([0.7, 0.7, 1.2])).astype(
            np.float32
        )
        # stand on the floor somewhere not hugging a wall
        center_xy = (rng.random(2).astype(np.float32) - 0.5) * (
            np.array(size[:2], np.float32) - dims[:2] - 0.6
        )
        lo = np.array(
            [center_xy[0] - dims[0] / 2, center_xy[1] - dims[1] / 2, -half[2]],
            np.float32,
        )
        hi = lo + dims
        boxes.append(np.stack([lo, hi]))
        hue = np.zeros(3, np.float32)
        hue[k % 3] = 0.8
        hue[(k + 1) % 3] = 0.3 + 0.4 * rng.random()
        for axis in range(3):
            for sign in (0, 1):
                m = n_per_occluder // 6
                p = (lo + rng.random((m, 3)).astype(np.float32) * dims)
                p[:, axis] = hi[axis] if sign else lo[axis]
                uv = p[:, [d for d in range(3) if d != axis]]
                c = np.clip(
                    hue[None, :]
                    + 0.25 * np.sin(12.0 * uv[:, :1])
                    + 0.15 * uv[:, 1:2],
                    0.05,
                    1.0,
                ).astype(np.float32)
                pts.append(p)
                cols.append(np.broadcast_to(c, (m, 3)).copy())
    return (
        np.concatenate(pts),
        np.concatenate(cols),
        np.stack(boxes) if boxes else np.zeros((0, 2, 3), np.float32),
    )


def random_pose_inside(rng: np.random.Generator,
                       size: Tuple[float, float, float] = (6.0, 4.0, 3.0),
                       margin: float = 0.35,
                       yaw_only: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """A random pose well inside the room's quantile box."""
    half = np.array(size, np.float32) / 2
    lo = -half * (1 - margin)
    hi = half * (1 - margin)
    t = (rng.random(3).astype(np.float32) * (hi - lo) + lo).astype(np.float32)
    yaw = rng.random() * 2 * np.pi
    if yaw_only:
        ypr = np.array([yaw, 0.0, 0.0], np.float32)
    else:
        ypr = np.array(
            [yaw, (rng.random() - 0.5) * 0.3, (rng.random() - 0.5) * 0.3],
            np.float32,
        )
    return t, ypr


def pose_outside_occluders(
    rng: np.random.Generator,
    occluders: np.ndarray,
    size: Tuple[float, float, float] = (6.0, 4.0, 3.0),
    margin: float = 0.35,
    clearance: float = 0.25,
    yaw_only: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """random_pose_inside, rejecting poses inside (or hugging) an occluder."""
    grown = occluders.copy()
    if grown.size:
        grown[:, 0] -= clearance
        grown[:, 1] += clearance
    for _ in range(200):
        t, ypr = random_pose_inside(rng, size, margin, yaw_only)
        if not grown.size or not bool(
            np.any(np.all((t >= grown[:, 0]) & (t <= grown[:, 1]), axis=1))
        ):
            return t, ypr
    raise RuntimeError("no free pose found among occluders")


def render_at(xyz, rgb, t, ypr, resolution: Tuple[int, int] = (256, 512),
              device="cuda") -> torch.Tensor:
    """The ground-truth panorama at pose (t, ypr): (H, W, 3) in [0, 1] on
    ``device``."""
    dev = resolve_device(device)
    t = as_tensor(t, dev, torch.float32)
    ypr = as_tensor(ypr, dev, torch.float32)
    cam = transform_cloud(Pose(t=t, yaw=ypr[0], pitch=ypr[1], roll=ypr[2]),
                          as_tensor(xyz, dev, torch.float32))
    return render_pano(cam, as_tensor(rgb, dev, torch.float32),
                       resolution) / 255.0


@dataclasses.dataclass(frozen=True)
class RoomScene:
    """A box room with axis-aligned box occluders and procedural textures.

    ``occluders`` is (K, 2, 3) of (lo, hi) corners; ``occluder_hues`` (K, 3)
    base colors.  The scene is the single source of truth for geometry AND
    photometry: :func:`scene_cloud` and :func:`raycast_pano` both evaluate
    the same texture functions.

    ``center`` translates the whole scene in world coordinates: occluder
    corners are stored in WORLD coords (already offset), wall geometry is
    ``center ± size/2``.  A floor-referenced scene (``make_scene(...,
    floor_at_zero=True)``) puts the floor at z=0 like real capture datasets,
    so the reference's ``z_prior = 1.5`` camera-height prior applies
    unmodified (reference configs/omniscenes.ini:14, utils.py:393-399).
    """

    size: Tuple[float, float, float]
    texture: str = "checker"
    occluders: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2, 3), np.float32)
    )
    occluder_hues: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.float32)
    )
    center: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )


def make_scene(
    rng: np.random.Generator,
    size: Tuple[float, float, float] = (6.0, 4.0, 3.0),
    n_occluders: int = 0,
    texture: str = "checker",
    floor_at_zero: bool = False,
) -> RoomScene:
    """Random scene: floor-standing box occluders away from the walls."""
    half = np.array(size, np.float32) / 2
    center = np.array(
        [0.0, 0.0, half[2] if floor_at_zero else 0.0], np.float32
    )
    boxes, hues = [], []
    for k in range(n_occluders):
        dims = (0.3 + rng.random(3) * np.array([0.7, 0.7, 1.2])).astype(
            np.float32
        )
        center_xy = (rng.random(2).astype(np.float32) - 0.5) * (
            np.array(size[:2], np.float32) - dims[:2] - 0.6
        )
        lo = center + np.array(
            [center_xy[0] - dims[0] / 2, center_xy[1] - dims[1] / 2, -half[2]],
            np.float32,
        )
        boxes.append(np.stack([lo, lo + dims]))
        hue = np.zeros(3, np.float32)
        hue[k % 3] = 0.8
        hue[(k + 1) % 3] = 0.3 + 0.4 * rng.random()
        hues.append(hue)
    return RoomScene(
        size=tuple(float(s) for s in size),
        texture=texture,
        occluders=np.stack(boxes) if boxes else np.zeros((0, 2, 3), np.float32),
        occluder_hues=np.stack(hues) if hues else np.zeros((0, 3), np.float32),
        center=center,
    )


def scene_pose(
    scene: RoomScene,
    rng: np.random.Generator,
    margin: float = 0.35,
    yaw_only: bool = True,
    z_range: Tuple[float, float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random camera pose inside the scene, outside every occluder.

    ``z_range`` optionally pins the camera height band in WORLD z (e.g.
    (1.3, 1.7) for a handheld capture in a floor-referenced scene).
    """
    for _ in range(200):
        t, ypr = random_pose_inside(rng, scene.size, margin, yaw_only)
        t = t + np.asarray(scene.center, np.float32)
        if z_range is not None:
            t[2] = np.float32(
                z_range[0] + rng.random() * (z_range[1] - z_range[0])
            )
        occ = scene.occluders
        if not occ.size or not bool(
            np.any(np.all((t >= occ[:, 0] - 0.25) & (t <= occ[:, 1] + 0.25),
                          axis=1))
        ):
            return t, ypr
    raise RuntimeError("no free pose found among occluders")


def _scene_faces(scene: RoomScene):
    """All textured faces: 6 walls + 6 per occluder, with areas."""
    size = np.array(scene.size, np.float32)
    faces = []
    for axis, sign in _WALL_FACES:
        d0, d1 = _other_dims(axis)
        faces.append(("wall", axis, sign, None, float(size[d0] * size[d1])))
    for k in range(scene.occluders.shape[0]):
        lo, hi = scene.occluders[k]
        ext = hi - lo
        for axis, sign in _WALL_FACES:
            d0, d1 = _other_dims(axis)
            faces.append(("occ", axis, sign, k, float(ext[d0] * ext[d1])))
    return faces


def scene_cloud(
    scene: RoomScene, rng: np.random.Generator, n_points: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample an area-weighted surface point cloud with scene textures.

    Like a real scan, occluded wall points are still present (a scanner sees
    behind furniture from other viewpoints even when the query camera can't).
    """
    faces = _scene_faces(scene)
    areas = np.array([f[4] for f in faces], np.float64)
    counts = rng.multinomial(n_points, areas / areas.sum())
    size = np.array(scene.size, np.float32)
    half = size / 2
    pts, cols = [], []
    for (kind, axis, sign, k, _area), m in zip(faces, counts):
        if m == 0:
            continue
        uv = rng.random((m, 2)).astype(np.float32)
        d0, d1 = _other_dims(axis)
        p = np.empty((m, 3), np.float32)
        ctr = np.asarray(scene.center, np.float32)
        if kind == "wall":
            p[:, d0] = (uv[:, 0] - 0.5) * size[d0] + ctr[d0]
            p[:, d1] = (uv[:, 1] - 0.5) * size[d1] + ctr[d1]
            p[:, axis] = sign * half[axis] + ctr[axis]
            c = _wall_color(uv[:, 0], uv[:, 1], axis, sign, scene.texture)
        else:
            lo, hi = scene.occluders[k]
            p[:, d0] = lo[d0] + uv[:, 0] * (hi[d0] - lo[d0])
            p[:, d1] = lo[d1] + uv[:, 1] * (hi[d1] - lo[d1])
            p[:, axis] = hi[axis] if sign > 0 else lo[axis]
            c = _occluder_color(p, axis, scene.occluder_hues[k])
        pts.append(p)
        cols.append(c)
    return np.concatenate(pts), np.concatenate(cols)


def raycast_pano(
    scene: RoomScene,
    t: np.ndarray,
    ypr: np.ndarray,
    resolution: Tuple[int, int] = (256, 512),
) -> np.ndarray:
    """Render a DENSE equirectangular panorama by ray casting the scene.

    Every pixel center is inverse-projected to a camera ray using the exact
    conventions of :func:`ops.projection.spherical_project` and
    grid_sample's align_corners=False pixel transform (pixel (r, c) center
    <=> normalized coords ((2c+1)/W - 1, (2r+1)/H - 1)), so a cloud point
    visible at pose (t, ypr) bilinearly samples its own surface color.
    The camera pose convention matches the reference (X_cam = R(X - t),
    reference omniloc.py:141-142).

    Returns (H, W, 3) float32 in [0, 1]; every pixel is lit (no black
    border/background — colors clip to >= 0.05 like the cloud's).
    """
    H, W = resolution
    # pixel centers -> normalized coords -> (theta, phi) -> camera-frame ray
    x_n = (2.0 * np.arange(W, dtype=np.float64) + 1.0) / W - 1.0
    y_n = (2.0 * np.arange(H, dtype=np.float64) + 1.0) / H - 1.0
    phi = np.pi * (1.0 - x_n)          # azimuth in [0, 2pi)
    theta = np.pi * (y_n + 1.0) / 2.0  # polar from +z in (0, pi)
    st, ct = np.sin(theta), np.cos(theta)
    az = phi - np.pi
    d_cam = np.empty((H, W, 3), np.float64)
    d_cam[..., 0] = st[:, None] * np.cos(az)[None, :]
    d_cam[..., 1] = st[:, None] * np.sin(az)[None, :]
    d_cam[..., 2] = ct[:, None]
    R = rot_from_ypr(torch.as_tensor(np.asarray(ypr, np.float32))).numpy(
    ).astype(np.float64)
    d = d_cam @ R  # d_world = R^T d_cam
    o = np.asarray(t, np.float64).reshape(3)
    ctr = np.asarray(scene.center, np.float64)

    # room walls: exit intersection of the AABB interior (scene-local coords)
    half = np.asarray(scene.size, np.float64) / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        bound = np.where(d > 0, half, -half)
        t_ax = (bound - (o - ctr)) / d
    t_ax = np.where(np.isfinite(t_ax) & (t_ax > 0), t_ax, np.inf)
    wall_axis = np.argmin(t_ax, axis=-1)
    best_t = np.take_along_axis(t_ax, wall_axis[..., None], -1)[..., 0]
    occ_id = np.full((H, W), -1, np.int32)
    occ_axis = np.zeros((H, W), np.int32)

    # occluders: nearest entry intersection (camera is outside every box)
    for k in range(scene.occluders.shape[0]):
        lo = scene.occluders[k, 0].astype(np.float64)
        hi = scene.occluders[k, 1].astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (lo - o) / d
            t2 = (hi - o) / d
        tn_ax = np.minimum(t1, t2)
        tf_ax = np.maximum(t1, t2)
        tn = np.max(tn_ax, axis=-1)
        tf = np.min(tf_ax, axis=-1)
        hit = (tn < tf) & (tn > 1e-9) & (tn < best_t)
        best_t = np.where(hit, tn, best_t)
        occ_id = np.where(hit, k, occ_id)
        occ_axis = np.where(hit, np.argmax(tn_ax, axis=-1), occ_axis)

    p = o + best_t[..., None] * d
    img = np.zeros((H, W, 3), np.float32)
    size = np.asarray(scene.size, np.float64)
    for axis, sign in _WALL_FACES:
        m = (occ_id < 0) & (wall_axis == axis) & (
            (d[..., axis] > 0) if sign > 0 else (d[..., axis] <= 0)
        )
        if not m.any():
            continue
        d0, d1 = _other_dims(axis)
        u = (p[..., d0][m] - ctr[d0]) / size[d0] + 0.5
        v = (p[..., d1][m] - ctr[d1]) / size[d1] + 0.5
        img[m] = _wall_color(u, v, axis, sign, scene.texture)
    for k in range(scene.occluders.shape[0]):
        for axis in range(3):
            m = (occ_id == k) & (occ_axis == axis)
            if not m.any():
                continue
            img[m] = _occluder_color(p[m], axis, scene.occluder_hues[k])
    return img


# ---- synthetic Stanford2D-3D-S tree (port of scripts/make_synth_dataset.py)

_FLIP_Z = np.array([[-1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]])

_ROOM_SIZES = [
    (6.0, 4.0, 3.0),
    (5.0, 5.0, 2.8),
    (8.0, 3.5, 3.2),
    (4.5, 6.5, 3.0),
]


# -- capture-realism degradations ------------------------------------------
#
# The ray-cast oracle renders ideal captures; real Stanford2D-3D-S and
# OmniScenes data carry sensor noise, JPEG blocking, motion blur,
# vignetting and scanner defects (depth noise, scan holes).  These degrade
# a rendered query image or a sampled cloud, drawing the JAX package's
# numbers from the same generator.

IMAGE_REALISM_ARMS = ("noise", "jpeg", "blur", "vignette")
CLOUD_REALISM_ARMS = ("depth-noise", "holes")
# each arm's strength when none is given
REALISM_DEFAULTS = {"noise": 0.02, "jpeg": 60, "blur": 9, "vignette": 0.4,
                    "depth-noise": 0.01, "holes": 0.10}


def apply_image_realism(u8: np.ndarray, arm: str, val: float,
                        rng: np.random.Generator) -> np.ndarray:
    """Degrade a uint8 RGB capture like a real camera or codec would.

    Arms (val = strength):
      noise:    per-pixel Gaussian sensor noise, sigma = val in [0, 1]
                units (0.02 ~ a mid-ISO handheld capture).
      jpeg:     encode and decode at quality = int(val), with the port's
                baseline 4:2:0 codec (``harness.imaging``; the JAX package
                uses cv2's libjpeg, whose tables and rounding it shares).
      blur:     horizontal motion blur, kernel length = int(val) px,
                wrapping across the panorama's seam.
      vignette: elevation falloff, gain 1 - val * (2*row/(H-1) - 1)^2.
    """
    img = np.asarray(u8)
    if img.dtype != np.uint8:
        raise ValueError("apply_image_realism expects a uint8 capture")
    if arm == "noise":
        f = img.astype(np.float32) / 255.0
        f = f + rng.normal(0.0, float(val), f.shape).astype(np.float32)
        return np.clip(np.round(f * 255.0), 0, 255).astype(np.uint8)
    if arm == "jpeg":
        from .harness.imaging import jpeg_decode, jpeg_encode

        return jpeg_decode(jpeg_encode(img, int(val)))
    if arm == "blur":
        # horizontal box blur with periodic wrap: the azimuth is periodic
        k = max(3, int(val) | 1)
        f = img.astype(np.float32)
        acc = np.zeros_like(f)
        for off in range(-(k // 2), k // 2 + 1):
            acc += np.roll(f, off, axis=1)
        return np.clip(np.round(acc / k), 0, 255).astype(np.uint8)
    if arm == "vignette":
        H = img.shape[0]
        y = (2.0 * np.arange(H, dtype=np.float32) / max(H - 1, 1)) - 1.0
        gain = 1.0 - float(val) * y * y
        f = img.astype(np.float32) * gain[:, None, None]
        return np.clip(np.round(f), 0, 255).astype(np.uint8)
    raise ValueError(f"unknown image realism arm {arm!r} "
                     f"(have {IMAGE_REALISM_ARMS})")


def apply_cloud_realism(xyz: np.ndarray, rgb: np.ndarray, arm: str,
                        val: float, rng: np.random.Generator):
    """Degrade a sampled cloud like a real scanner would.

    Arms (val = strength):
      depth-noise: Gaussian positional noise, sigma = val metres.
      holes:       remove val of the points as 8 random spherical caps
                   (glass, occlusion shadows, registration gaps).
    """
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    if arm == "depth-noise":
        return (
            xyz + rng.normal(0.0, float(val), xyz.shape).astype(np.float32),
            rgb,
        )
    if arm == "holes":
        n = xyz.shape[0]
        target = int(n * float(val))
        keep = np.ones(n, bool)
        per = max(1, target // 8)
        for _ in range(8):
            c = xyz[rng.integers(0, n)]
            d = np.linalg.norm(xyz - c, axis=1)
            d[~keep] = np.inf  # already removed: never recount
            keep[np.argsort(d)[:per]] = False
        return xyz[keep], rgb[keep]
    raise ValueError(f"unknown cloud realism arm {arm!r} "
                     f"(have {CLOUD_REALISM_ARMS})")


def _stanford_euler_for(R: np.ndarray) -> list:
    """The pose JSON's final_camera_rotation that the harness decodes back
    to R (the inverse of data.stanford's convention)."""
    from scipy.spatial.transform import Rotation

    M = (_FLIP_Z @ R).T  # = permute(euler_matrix)
    r = np.zeros((3, 3))
    r[:, 2] = M[:, 0]
    r[:, 0] = M[:, 1]
    r[:, 1] = M[:, 2]
    return Rotation.from_matrix(r).as_euler("xyz").tolist()


def _write_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cols = np.hstack([xyz, np.round(rgb * 255)])
    np.savetxt(path, cols, fmt="%.6f %.6f %.6f %d %d %d")


def _realism_strength(oracle: str, realism, realism_val):
    """The arm's strength (its default when none is given); a realism arm
    needs the ray-cast oracle."""
    if realism is None:
        return None
    if oracle != "raycast":
        raise ValueError("a realism arm needs oracle='raycast'")
    if realism not in REALISM_DEFAULTS:
        raise ValueError(f"unknown realism arm {realism!r} "
                         f"(have {tuple(REALISM_DEFAULTS)})")
    return REALISM_DEFAULTS[realism] if realism_val is None else realism_val


def write_synth_stanford(root: str, rooms: int = 1, queries: int = 3,
                         points: int = 30000, height: int = 512,
                         seed: int = 7, oracle: str = "raycast",
                         realism=None, realism_val=None) -> None:
    """Write a synthetic Stanford2D-3D-S tree under ``root``: clouds,
    panoramas (PNG) and pose JSONs in the dataset's layout, so the CLI runs
    on it with no download.  Same file names, cloud format, poses and
    random stream as ``scripts/make_synth_dataset.py --datasets stanford``.

    ``oracle="raycast"`` renders dense camera-like panoramas of cluttered
    rooms; ``"splat"`` z-buffers the cloud itself (on the CPU).
    ``realism`` (ray-cast only) degrades every panorama
    (``IMAGE_REALISM_ARMS``) or every cloud (``CLOUD_REALISM_ARMS``) at
    strength ``realism_val`` (default ``REALISM_DEFAULTS[realism]``).
    ``seed`` may also be a ``np.random.Generator`` to draw from.
    """
    from .harness.imaging import imwrite_rgb

    realism_val = _realism_strength(oracle, realism, realism_val)
    rng = np.random.default_rng(seed)  # a Generator comes back as it is
    area = 1
    for ri in range(rooms):
        size = _ROOM_SIZES[ri % len(_ROOM_SIZES)]
        xyz, rgb, render, sample_pose, _ = _room_oracle(
            rng, size, points, oracle, realism=realism,
            realism_val=realism_val)
        room_type, room_no = "office", str(ri + 1)
        _write_cloud(
            os.path.join(root, "stanford", "pcd_not_aligned", f"area_{area}",
                         f"{room_type}_{room_no}.txt"),
            xyz, rgb,
        )
        for qi in range(queries):
            t, ypr = sample_pose()
            img = render(t, ypr, (height, 2 * height))
            cam_id = f"{ri:02d}{qi:02d}synth"
            stem = f"camera_{cam_id}_{room_type}_{room_no}_frame_equirectangular_domain"
            pano = os.path.join(root, "stanford", "pano", f"area_{area}",
                                f"{stem}_rgb.png")
            os.makedirs(os.path.dirname(pano), exist_ok=True)
            imwrite_rgb(pano, (img * 255).astype(np.uint8))

            R = rot_from_ypr(torch.as_tensor(ypr, dtype=torch.float32)).numpy()
            pose = {
                "camera_location": t.astype(float).tolist(),
                "final_camera_rotation": _stanford_euler_for(R),
            }
            pose_path = os.path.join(root, "stanford", "pose", f"area_{area}",
                                     f"{stem}_pose.json")
            os.makedirs(os.path.dirname(pose_path), exist_ok=True)
            with open(pose_path, "w") as f:
                json.dump(pose, f)


def _room_oracle(rng, size, points, oracle, floor_at_zero=False,
                 realism=None, realism_val=None):
    """A room's cloud, a renderer ``render(t, ypr, resolution)`` and a pose
    sampler ``pose(z_range=None)``, drawing from ``rng`` as
    ``scripts/make_synth_dataset.py`` does; also the occluder boxes.  A
    cloud realism arm degrades the cloud once, an image arm each render."""
    if oracle not in ("raycast", "splat"):
        raise ValueError(f"oracle must be 'raycast' or 'splat', got {oracle!r}")
    if oracle == "raycast":
        scene = make_scene(rng, size=size, n_occluders=2, texture="checker",
                           floor_at_zero=floor_at_zero)
        xyz, rgb = scene_cloud(scene, rng, points)
        if realism in CLOUD_REALISM_ARMS:
            xyz, rgb = apply_cloud_realism(xyz, rgb, realism, realism_val,
                                           rng)

        def render(t, ypr, resolution):
            img = raycast_pano(scene, t, ypr, resolution)
            if realism in IMAGE_REALISM_ARMS:
                u8 = (img * 255).astype(np.uint8)
                img = apply_image_realism(u8, realism, realism_val,
                                          rng).astype(np.float32) / 255.0
            return img

        def pose(z_range=None):
            return scene_pose(scene, rng, z_range=z_range)

        return xyz, rgb, render, pose, scene.occluders
    xyz, rgb = make_room(rng, n_per_wall=points // 6, size=size,
                         texture="checker")

    def render(t, ypr, resolution):
        return render_at(xyz, rgb, t, ypr, resolution, device="cpu").numpy()

    def pose(z_range=None):
        return random_pose_inside(rng, size)

    return xyz, rgb, render, pose, np.zeros((0, 2, 3), np.float32)


def _inside_any(t, occluders, clearance=0.15) -> bool:
    if not occluders.size:
        return False
    return bool(np.any(np.all(
        (t >= occluders[:, 0] - clearance) & (t <= occluders[:, 1] + clearance),
        axis=1)))


def write_synth_omniscenes(root: str, rooms: int = 1, queries: int = 3,
                           points: int = 30000, height: int = 512,
                           seed: int = 7, oracle: str = "raycast",
                           realism=None, realism_val=None) -> None:
    """Write a synthetic OmniScenes tree under ``root`` (split "extreme"):
    clouds, panoramas (JPEG q95, by the port's own encoder) and ``[R|t]``
    pose files in the dataset's layout.  Same file names, clouds, poses and
    random stream as ``scripts/make_synth_dataset.py --datasets
    omniscenes``.

    Ray-cast rooms are floor-referenced (floor at z = 0), so the shipped
    ``z_prior = 1.5`` applies, and a video is a handheld walk: after a
    first pose at 1.3-1.7 m, each frame moves ~2 cm and turns ~0.9 deg,
    keeps its height band and never steps into an occluder.  ``realism``,
    ``realism_val`` and ``seed`` as in :func:`write_synth_stanford`."""
    from .harness.imaging import imwrite_rgb

    realism_val = _realism_strength(oracle, realism, realism_val)
    rng = np.random.default_rng(seed)
    for ri in range(rooms):
        size = _ROOM_SIZES[ri % len(_ROOM_SIZES)]
        xyz, rgb, render, sample_pose, occluders = _room_oracle(
            rng, size, points, oracle, floor_at_zero=True, realism=realism,
            realism_val=realism_val)
        room_type, room_no = "pyebang", str(ri + 1)
        _write_cloud(os.path.join(root, "omniscenes", "pcd",
                                  f"{room_type}_{room_no}.txt"), xyz, rgb)
        video = f"handheld_{room_type}_{room_no}_scene_1"
        t = ypr = None
        for qi in range(queries):
            if oracle == "raycast" and t is not None:
                half_xy = np.array(size[:2], np.float32) / 2 - 0.4
                for _ in range(50):
                    cand = t + rng.normal(0, 0.02, 3).astype(np.float32)
                    cand[2] = np.clip(cand[2], 1.3, 1.7)
                    cand[:2] = np.clip(cand[:2], -half_xy, half_xy)
                    if not _inside_any(cand, occluders):
                        t = cand
                        break
                ypr = ypr + np.float32([rng.normal(0.015, 0.01), 0, 0])
            else:
                t, ypr = sample_pose(
                    z_range=(1.3, 1.7) if oracle == "raycast" else None)
            img = render(t, ypr, (height, 2 * height))
            pano = os.path.join(root, "omniscenes", "extreme_pano", video,
                                f"{qi:06d}.jpg")
            os.makedirs(os.path.dirname(pano), exist_ok=True)
            imwrite_rgb(pano, (img * 255).astype(np.uint8))
            R = rot_from_ypr(torch.as_tensor(ypr, dtype=torch.float32)).numpy()
            pose_path = os.path.join(root, "omniscenes", "extreme_pose",
                                     video, f"{qi:06d}.txt")
            os.makedirs(os.path.dirname(pose_path), exist_ok=True)
            np.savetxt(pose_path, np.hstack([R, t.reshape(3, 1)]))


def edge_plan_group(rng: np.random.Generator, specs, block: int, window: int,
                    n_points: int, layout: str = "compact", rgb=None,
                    device="cpu"):
    """One hand-built plan group, in ``layout`` ("compact", "q8" or "f32"),
    for the slab kernels' edge cases.

    ``specs[b] = (table window, real samples)`` of block b.  The real
    samples sit at the head of the block, as the plan builders put them, so
    a block with none holds only pads.  They draw their row, pair, 8-bit
    fractions and point id from ``rng``; each block's first sample has row
    ``window - 1`` and pair 127.  An f32 group takes its targets from
    ``rgb[pid]`` ((n_points, 3) colours) and keeps its point ids in its pid
    row.  Returns (fields, windows, the point ids as (nb, 1, block) f32;
    pads 0)."""
    nb = len(specs)
    li = rng.integers(0, window, (nb, block))
    cid = rng.integers(0, 128, (nb, block))
    li[:, 0] = window - 1
    cid[:, 0] = 127
    wx = rng.integers(0, 256, (nb, block))
    wy = rng.integers(0, 256, (nb, block))
    pid = rng.integers(0, n_points, (nb, block))
    n_real = np.array([n for _, n in specs], np.int64).reshape(nb)
    real = np.arange(block)[None] < n_real[:, None]
    pid = np.where(real, pid, 0)
    if layout == "q8":
        g = (li << 23) | (cid << 16) | (wx << 8) | wy
        g = np.where(real, g, 511 << 23).astype(np.uint32).view(np.int32)
        fields = g[:, None]
    elif layout == "compact":
        fields = np.stack([np.where(real, li * 128 + cid, -1),
                           np.where(real, wx / 255.0, 0.0),
                           np.where(real, wy / 255.0, 0.0)], 1)
        fields = fields.astype(np.float32)
    elif layout == "f32":
        tgt = np.where(real[..., None], np.asarray(rgb, np.float32)[pid], 0.0)
        # pads as the builder makes them: lidx = cid = -1, the rest 0
        fields = np.stack([np.where(real, li, -1),
                           np.where(real, wx / 255.0, 0.0),
                           np.where(real, wy / 255.0, 0.0), tgt[..., 0],
                           tgt[..., 1], tgt[..., 2], np.where(real, cid, -1),
                           pid], 1).astype(np.float32)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    tps = pid.astype(np.float32)[:, None]
    windows = np.array([w for w, _ in specs], np.int32).reshape(nb)
    dev = resolve_device(device)
    return (torch.tensor(fields, device=dev), torch.tensor(windows, device=dev),
            torch.tensor(tps, device=dev))
