"""A one-minute demo: build a synthetic room, localize a panorama, save
images (port of ``scripts/demo.py``).

    python -m piccolo_tpu_torch.demo [--out DIR] [--device cuda|cpu]

No dataset needed.  Writes the query panorama, the panorama rendered at
the estimated pose and the two stacked (``query.png``, ``estimated.png``,
``side_by_side.png``) to ``--out`` (default: ``piccolo_demo`` in the
temporary directory).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from .device import resolve_device
from .harness.imaging import imwrite_rgb, vconcat
from .harness.localize import _order_bounds, _pad_cloud, _result_render
from .harness.metrics import rotation_error_deg, translation_error
from .init.candidates import (
    default_init_dict,
    generate_rot_points,
    generate_trans_points,
)
from .ops.rotation import rot_from_ypr
from .pipeline import localize_query
from .testing import make_room, random_pose_inside, render_at
from .utils import enable_compilation_cache

__all__ = ["main"]


def main(argv=None) -> dict:
    """Run the demo; returns the errors and the paths written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "piccolo_demo"))
    ap.add_argument("--points", type=int, default=60000)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    enable_compilation_cache()

    rng = np.random.default_rng(args.seed)
    size = (6.0, 4.0, 3.0)
    print("building synthetic room...")
    xyz, rgb = make_room(rng, n_per_wall=args.points // 6, size=size,
                         texture="checker")
    xyz_d, rgb_d, mask_d = _pad_cloud(xyz, rgb, dev)
    lo, hi = _order_bounds(xyz, 0.05)

    gt_t, gt_ypr = random_pose_inside(rng, size)
    print(f"ground-truth pose: t={gt_t.round(3)} yaw={gt_ypr[0]:.3f}")
    H, W = args.height, 2 * args.height
    img = render_at(xyz, rgb, gt_t, gt_ypr, (H, W), device=dev)
    img_init = img[::2, ::2]

    d = default_init_dict(xy_only=True, num_trans=50, yaw_only=True,
                          num_yaw=8, z_prior=None)
    trans = generate_trans_points(xyz, d)
    rot = generate_rot_points(d)
    pad = (-trans.shape[0]) % 8
    valid = np.arange(trans.shape[0] + pad) < trans.shape[0]
    if pad:
        trans = np.concatenate([trans, np.zeros((pad, 3), np.float32)])

    print("localizing (the first call builds and captures; reruns are "
          "fast)...")
    t0 = time.time()
    res = localize_query(
        img_init, img, xyz_d, rgb_d, trans, rot, valid, lo, hi, mask_d,
        num_intermediate=20, num_input=6, num_iter=100, masked=True,
        device=dev,
    )
    t = res.t.cpu().numpy()
    R = res.rot.cpu().numpy()
    print(f"done in {time.time() - t0:.1f}s")

    gt_R = rot_from_ypr(torch.as_tensor(gt_ypr)).numpy()
    t_err = translation_error(gt_t, t)
    r_err = rotation_error_deg(gt_R, R)
    print(f"estimated pose:    t={t.round(3)}")
    print(f"t_error = {t_err * 100:.2f} cm, r_error = {r_err:.3f} deg, "
          f"loss = {float(res.loss):.4f}")

    est = _result_render(t, R, xyz_d, rgb_d, mask_d, (H // 2, W // 2))
    query_u8 = (img.cpu().numpy() * 255).astype(np.uint8)[::2, ::2]
    paths = {name: os.path.join(args.out, f"{name}.png")
             for name in ("query", "estimated", "side_by_side")}
    imwrite_rgb(paths["query"], query_u8)
    imwrite_rgb(paths["estimated"], est)
    imwrite_rgb(paths["side_by_side"], vconcat(query_u8, est))
    print(f"images written to {args.out}/")
    return dict(t_err=t_err, r_err=r_err, paths=paths)


if __name__ == "__main__":
    main()
