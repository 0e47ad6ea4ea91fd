"""Rooms, poses and panoramas from a seed: the benchmark's own frozen copy.

Copied from ``piccolo_tpu_torch/testing.py`` (``make_scene``,
``scene_pose``, ``random_pose_inside``, ``scene_cloud`` and the texture
functions) so that the yardstick does not move when the program's test
helpers do.  The ray caster is rewritten in plain torch (float64) so that
set-up renders 2-8 Mpx panoramas on the card instead of in numpy on the
host.  The conventions are the program's: ``x_cam = R(yaw, pitch, roll) @
(x_world - t)`` with ``R = RZ @ RY @ RX``, and a pixel centre maps to the
normalised coordinates of ``grid_sample(align_corners=False)``, so a cloud
point visible from the pose samples its own surface colour.

Imports numpy and torch only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

_WALL_FACES = ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1))


def _other_dims(axis: int) -> Tuple[int, int]:
    d = [i for i in range(3) if i != axis]
    return d[0], d[1]


def wall_color(u, v, axis: int, sign: int, texture: str, xp=np):
    """Wall texture of normalised surface coords (float32 math)."""
    base = [0.0, 0.0, 0.0]
    base[axis] = 0.75 if sign > 0 else 0.25
    if xp is np:
        u = np.asarray(u, np.float32)
        v = np.asarray(v, np.float32)
        c = np.asarray(base, np.float32) + 0.5 * np.stack([u, v, u * v], -1)
    else:
        u, v = u.float(), v.float()
        c = (torch.tensor(base, dtype=torch.float32, device=u.device)
             + 0.5 * torch.stack([u, v, u * v], -1))
    if texture == "checker":
        if xp is np:
            checker = ((u * 6).astype(int) + (v * 6).astype(int)) % 2
        else:
            checker = ((u * 6).to(torch.int64) + (v * 6).to(torch.int64)) % 2
        c = c * (0.6 + 0.4 * checker[..., None])
    if xp is np:
        return np.clip(c, 0.05, 1.0).astype(np.float32)
    return c.clamp(0.05, 1.0).float()


def occluder_color(p, axis: int, hue, xp=np):
    """Occluder-face texture as a function of world position."""
    d0, d1 = _other_dims(axis)
    if xp is np:
        c = (np.asarray(hue, np.float32)
             + 0.25 * np.sin(12.0 * np.asarray(p[..., d0], np.float32))[..., None]
             + 0.15 * np.asarray(p[..., d1], np.float32)[..., None])
        return np.clip(c, 0.05, 1.0).astype(np.float32)
    hue_t = torch.as_tensor(np.asarray(hue, np.float32), device=p.device)
    c = (hue_t + 0.25 * torch.sin(12.0 * p[..., d0].float())[..., None]
         + 0.15 * p[..., d1].float()[..., None])
    return c.clamp(0.05, 1.0).float()


@dataclasses.dataclass(frozen=True)
class RoomScene:
    """A box room with floor-standing box occluders; ``occluders`` (K, 2, 3)
    world (lo, hi) corners, walls at ``center +- size / 2``."""

    size: Tuple[float, float, float]
    texture: str
    occluders: np.ndarray
    occluder_hues: np.ndarray
    center: np.ndarray


def make_scene(rng: np.random.Generator, size, n_occluders: int,
               texture: str = "checker",
               floor_at_zero: bool = False) -> RoomScene:
    half = np.array(size, np.float32) / 2
    center = np.array([0.0, 0.0, half[2] if floor_at_zero else 0.0],
                      np.float32)
    boxes, hues = [], []
    for k in range(n_occluders):
        dims = (0.3 + rng.random(3) * np.array([0.7, 0.7, 1.2])).astype(
            np.float32)
        center_xy = (rng.random(2).astype(np.float32) - 0.5) * (
            np.array(size[:2], np.float32) - dims[:2] - 0.6)
        lo = center + np.array(
            [center_xy[0] - dims[0] / 2, center_xy[1] - dims[1] / 2,
             -half[2]], np.float32)
        boxes.append(np.stack([lo, lo + dims]))
        hue = np.zeros(3, np.float32)
        hue[k % 3] = 0.8
        hue[(k + 1) % 3] = 0.3 + 0.4 * rng.random()
        hues.append(hue)
    return RoomScene(
        size=tuple(float(s) for s in size), texture=texture,
        occluders=(np.stack(boxes) if boxes
                   else np.zeros((0, 2, 3), np.float32)),
        occluder_hues=(np.stack(hues) if hues
                       else np.zeros((0, 3), np.float32)),
        center=center)


def _random_pose_inside(rng, size, margin, yaw_only):
    half = np.array(size, np.float32) / 2
    lo = -half * (1 - margin)
    hi = half * (1 - margin)
    t = (rng.random(3).astype(np.float32) * (hi - lo) + lo).astype(np.float32)
    yaw = rng.random() * 2 * np.pi
    if yaw_only:
        return t, np.array([yaw, 0.0, 0.0], np.float32)
    return t, np.array([yaw, (rng.random() - 0.5) * 0.3,
                        (rng.random() - 0.5) * 0.3], np.float32)


def clear_of_occluders(scene: RoomScene, t, clearance: float = 0.25) -> bool:
    occ = scene.occluders
    return not occ.size or not bool(np.any(np.all(
        (t >= occ[:, 0] - clearance) & (t <= occ[:, 1] + clearance), axis=1)))


def scene_pose(scene: RoomScene, rng, margin: float = 0.35,
               yaw_only: bool = True, z_range=None):
    """A camera pose inside the room, 0.25 m clear of every occluder."""
    for _ in range(200):
        t, ypr = _random_pose_inside(rng, scene.size, margin, yaw_only)
        t = t + np.asarray(scene.center, np.float32)
        if z_range is not None:
            t[2] = np.float32(z_range[0] + rng.random()
                              * (z_range[1] - z_range[0]))
        if clear_of_occluders(scene, t):
            return t, ypr
    raise RuntimeError("no free pose found among occluders")


def _scene_faces(scene: RoomScene):
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


def scene_cloud(scene: RoomScene, rng, n_points: int):
    """Area-weighted surface samples with the scene's textures: (N, 3)
    xyz and (N, 3) rgb in [0, 1], float32."""
    faces = _scene_faces(scene)
    areas = np.array([f[4] for f in faces], np.float64)
    counts = rng.multinomial(n_points, areas / areas.sum())
    size = np.array(scene.size, np.float32)
    half = size / 2
    ctr = np.asarray(scene.center, np.float32)
    pts, cols = [], []
    for (kind, axis, sign, k, _), m in zip(faces, counts):
        if m == 0:
            continue
        uv = rng.random((m, 2)).astype(np.float32)
        d0, d1 = _other_dims(axis)
        p = np.empty((m, 3), np.float32)
        if kind == "wall":
            p[:, d0] = (uv[:, 0] - 0.5) * size[d0] + ctr[d0]
            p[:, d1] = (uv[:, 1] - 0.5) * size[d1] + ctr[d1]
            p[:, axis] = sign * half[axis] + ctr[axis]
            c = wall_color(uv[:, 0], uv[:, 1], axis, sign, scene.texture)
        else:
            lo, hi = scene.occluders[k]
            p[:, d0] = lo[d0] + uv[:, 0] * (hi[d0] - lo[d0])
            p[:, d1] = lo[d1] + uv[:, 1] * (hi[d1] - lo[d1])
            p[:, axis] = hi[axis] if sign > 0 else lo[axis]
            c = occluder_color(p, axis, scene.occluder_hues[k])
        pts.append(p)
        cols.append(c)
    return np.concatenate(pts), np.concatenate(cols)


def rot_from_ypr_np(ypr) -> np.ndarray:
    """R = RZ(yaw) @ RY(pitch) @ RX(roll), float64."""
    y, p, r = (float(a) for a in ypr)
    cz, sz = math.cos(y), math.sin(y)
    cy, sy = math.cos(p), math.sin(p)
    cx, sx = math.cos(r), math.sin(r)
    RZ = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    RY = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    RX = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return RZ @ RY @ RX


def raycast_pano(scene: RoomScene, t, ypr, resolution, device) -> torch.Tensor:
    """Dense equirectangular panorama of the scene at pose (t, ypr) by ray
    casting, (H, W, 3) uint8 on ``device``; every pixel is lit."""
    H, W = resolution
    f64 = torch.float64
    dev = torch.device(device)
    x_n = (2.0 * torch.arange(W, dtype=f64, device=dev) + 1.0) / W - 1.0
    y_n = (2.0 * torch.arange(H, dtype=f64, device=dev) + 1.0) / H - 1.0
    az = math.pi * (1.0 - x_n) - math.pi
    theta = math.pi * (y_n + 1.0) / 2.0
    st, ct = torch.sin(theta), torch.cos(theta)
    d_cam = torch.stack([st[:, None] * torch.cos(az)[None, :],
                         st[:, None] * torch.sin(az)[None, :],
                         ct[:, None].expand(H, W)], -1)
    R = torch.as_tensor(rot_from_ypr_np(ypr), dtype=f64, device=dev)
    d = d_cam @ R  # world direction R^T d_cam
    o = torch.as_tensor(np.asarray(t, np.float64).reshape(3), device=dev)
    ctr = torch.as_tensor(np.asarray(scene.center, np.float64), device=dev)
    half = torch.as_tensor(np.asarray(scene.size, np.float64) / 2, device=dev)
    inf = torch.tensor(math.inf, dtype=f64, device=dev)
    # the room's walls: where the ray leaves the box
    bound = torch.where(d > 0, half, -half)
    t_ax = (bound - (o - ctr)) / d
    t_ax = torch.where(torch.isfinite(t_ax) & (t_ax > 0), t_ax, inf)
    best_t, wall_axis = t_ax.min(-1)
    occ_id = torch.full((H, W), -1, dtype=torch.int64, device=dev)
    occ_axis = torch.zeros((H, W), dtype=torch.int64, device=dev)
    for k in range(scene.occluders.shape[0]):
        lo = torch.as_tensor(scene.occluders[k, 0].astype(np.float64),
                             device=dev)
        hi = torch.as_tensor(scene.occluders[k, 1].astype(np.float64),
                             device=dev)
        t1 = (lo - o) / d
        t2 = (hi - o) / d
        tn_ax = torch.minimum(t1, t2)
        tn, tn_arg = tn_ax.max(-1)
        tf = torch.maximum(t1, t2).min(-1).values
        hit = (tn < tf) & (tn > 1e-9) & (tn < best_t)
        best_t = torch.where(hit, tn, best_t)
        occ_id = torch.where(hit, torch.full_like(occ_id, k), occ_id)
        occ_axis = torch.where(hit, tn_arg, occ_axis)
    p = o + best_t[..., None] * d
    img = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    size = torch.as_tensor(np.asarray(scene.size, np.float64), device=dev)
    for axis, sign in _WALL_FACES:
        m = (occ_id < 0) & (wall_axis == axis) & (
            (d[..., axis] > 0) if sign > 0 else (d[..., axis] <= 0))
        d0, d1 = _other_dims(axis)
        u = (p[..., d0][m] - ctr[d0]) / size[d0] + 0.5
        v = (p[..., d1][m] - ctr[d1]) / size[d1] + 0.5
        img[m] = wall_color(u, v, axis, sign, scene.texture, xp=torch)
    for k in range(scene.occluders.shape[0]):
        for axis in range(3):
            m = (occ_id == k) & (occ_axis == axis)
            img[m] = occluder_color(p[m], axis, scene.occluder_hues[k],
                                    xp=torch)
    return (img * 255).to(torch.uint8)
