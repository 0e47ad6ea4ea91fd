"""Synthetic accuracy evaluation: many rooms x queries, with occluders (port
of ``scripts/eval_synth.py``).

    python -m piccolo_tpu_torch.eval_synth [--rooms 6] [--queries 4]
        [--points 60000] [--seed 11] [--device cuda|cpu]

The real Stanford2D-3D-S / OmniScenes datasets are not in the repo, so the
accuracy evidence comes from the render-then-recover oracle: several room
geometries, plain / checker / cluttered scenes (box occluders give real
occlusion and parallax), and the ray-cast oracle's dense camera-like
panoramas with their colour and capture-realism arms.  Every query runs
the fused pipeline (:func:`piccolo_tpu_torch.pipeline.localize_query`) at
the Stanford or OmniScenes budget and is scored against both success
criteria.

The command line, the cases drawn from ``--seed`` and the plan admission
are the JAX script's, so both measure the same thing: the same rooms, poses
and images, the script's own plan budget (not the CLI's ladder), and its
per-query lines and JSON summary.  The summary adds ``device``: the card's
name and power limit as ``nvidia-smi`` reports them, or ``"cpu"``.  The
port runs on the card; without one it raises unless given ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import List

import numpy as np
import torch

from .color import color_match, color_mod
from .device import resolve_device
from .harness.localize import _order_bounds, _pad_cloud, _pad_rgb, synth_ablate
from .harness.metrics import (
    OMNISCENES_R_THRESH_DEG,
    OMNISCENES_T_THRESH,
    STANFORD_R_THRESH_DEG,
    STANFORD_T_THRESH,
    rotation_error_deg,
    translation_error,
)
from .init.candidates import (
    default_init_dict,
    generate_rot_points,
    generate_trans_points,
)
from .init.refine import build_hist_plan, hist_plan_bytes
from .kernels.slab_sampling import (
    build_grid_plan,
    default_plan_bytes_cap,
    plan_bytes_estimate,
)
from .ops.rotation import rot_from_ypr
from .pipeline import localize_query
from .testing import (
    REALISM_DEFAULTS,
    apply_cloud_realism,
    apply_image_realism,
    make_cluttered_room,
    make_room,
    make_scene,
    pose_outside_occluders,
    raycast_pano,
    render_at,
    scene_cloud,
    scene_pose,
)
from .utils import enable_compilation_cache

__all__ = ["build_parser", "parse_args", "make_eval_room", "make_eval_query",
           "run_query", "summarize", "device_label", "main"]

_ROOM_SIZES = [
    (6.0, 4.0, 3.0),
    (5.0, 5.0, 2.8),
    (8.0, 3.5, 3.2),
    (4.5, 6.5, 3.0),
    (7.0, 5.0, 2.6),
    (4.0, 4.0, 3.4),
]
_KINDS = ("plain", "checker", "cluttered")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="synthetic accuracy evaluation of the fused query")
    ap.add_argument("--rooms", type=int, default=6)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--points", type=int, default=None,
                    help="cloud size (default 60k; 240k for the omniscenes "
                         "profile so the splat oracle's pixel coverage "
                         "matches a dense capture)")
    ap.add_argument("--height", type=int, default=None,
                    help="pano height (default 512; 1024 for the "
                         "omniscenes profile)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--profile", default="stanford",
                    choices=["stanford", "omniscenes"],
                    help="omniscenes = 2048x1024 panos, 150-trans init at "
                         "full resolution, top-50 (the reference "
                         "configs/omniscenes.ini budget)")
    ap.add_argument("--descent-table", default="float32",
                    choices=["auto", "float32", "bfloat16", "uint8"])
    ap.add_argument("--criterion", default="loss_histogram",
                    choices=["loss_histogram", "loss"],
                    help="init trim criterion ('loss' = top num_input by "
                         "stage-1 loss, no histogram trim)")
    ap.add_argument("--full-rot", action="store_true",
                    help="the reference stanford.ini rotation budget: a "
                         "full 4x4x4 yaw/pitch/roll grid (deduped) with GT "
                         "poses drawn with nonzero pitch/roll (the default "
                         "arm is yaw-only)")
    ap.add_argument("--sharpen", action="store_true",
                    help="apply the harness's sharpen_color prep per query "
                         "(color_mod on the init image, cloud colours "
                         "rebound, the slab plan's targets re-baked)")
    ap.add_argument("--prune", default=None, metavar="K,M",
                    help="descent-prune speed mode: all starts run K "
                         "iterations, the M best finish the budget "
                         "(e.g. 30,2; default off = full descent)")
    ap.add_argument("--slab-cap", type=float, default=None,
                    help="device-memory budget in bytes for the slab "
                         "plan's streams (default: default_plan_bytes_cap "
                         "of the device)")
    ap.add_argument("--no-slab", action="store_true",
                    help="score stage 1 with the gather engine instead of "
                         "the slab kernel")
    ap.add_argument("--no-hist-planes", action="store_true",
                    help="stage 2 re-splats per query instead of gathering "
                         "room-static winner-bin planes (planes are off "
                         "under --sharpen / criterion=loss anyway)")
    ap.add_argument("--oracle", default="splat",
                    choices=["splat", "raycast"],
                    help="GT renderer: 'splat' z-buffers the cloud itself "
                         "(pixel coverage scales with point count); "
                         "'raycast' renders dense camera-like panoramas by "
                         "ray casting the textured surfaces the cloud "
                         "samples, uint8-quantized like real captures")
    ap.add_argument("--perturb", default=None,
                    choices=["const", "gamma", "wb"],
                    help="apply the harness's synthetic illumination "
                         "ablation to the query image (reference "
                         "localize.py:384-393); pair with --match-color "
                         "(ray-cast oracle only)")
    ap.add_argument("--perturb-val", type=float, default=2.0,
                    help="ablation strength: divisor for const, exponent "
                         "for gamma (wb uses fixed 0.7/1.0/1.3 gains)")
    ap.add_argument("--match-color", action="store_true",
                    help="apply the harness's match_color prep (CDF "
                         "matching of the image to the cloud colours, "
                         "reference color_utils.py:146) per query")
    ap.add_argument("--realism", default=None,
                    choices=["noise", "jpeg", "blur", "vignette",
                             "depth-noise", "holes"],
                    help="capture-realism degradation arm (ray-cast oracle "
                         "only): sensor noise / JPEG / motion blur / "
                         "vignetting on the query image, or depth noise / "
                         "scan holes on the cloud "
                         "(testing.apply_*_realism)")
    ap.add_argument("--realism-val", type=float, default=None,
                    help="arm strength (defaults: noise 0.02, jpeg 60, "
                         "blur 9 px, vignette 0.4, depth-noise 0.01 m, "
                         "holes 0.10)")
    ap.add_argument("--seam-gt", action="store_true",
                    help="adversarial seam poses (ray-cast, yaw-only GT): "
                         "each GT yaw puts the nearest salient object "
                         "(occluder centre, else nearest wall corner) at "
                         "azimuth +-pi, the seam the reference's +-0.99 "
                         "grid clip truncates (utils.py:85,97)")
    ap.add_argument("--seam-wrap", action="store_true",
                    help="sample across the seam with the periodic "
                         "horizontal wrap (seam_wrap=True) instead of the "
                         "reference's clip")
    ap.add_argument("--floor-ref", action="store_true",
                    help="floor-referenced scenes (floor at z=0, camera "
                         "height 1.3-1.7 m) with the reference's shipped "
                         "z_prior = 1.5 (ray-cast oracle only)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or on the CPU")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The command line, validated, with the profile's budget filled in:
    ``num_trans``, ``num_intermediate`` and ``init_step`` join the flags."""
    args = build_parser().parse_args(argv)
    if args.realism:
        if args.oracle != "raycast":
            raise SystemExit("--realism needs --oracle raycast (the arms "
                             "model real-capture defects)")
        if args.realism_val is None:
            args.realism_val = REALISM_DEFAULTS[args.realism]
    if args.floor_ref and args.oracle != "raycast":
        raise SystemExit("--floor-ref needs --oracle raycast")
    if args.seam_gt and (args.oracle != "raycast" or args.full_rot):
        raise SystemExit("--seam-gt needs --oracle raycast and yaw-only GT")
    if args.oracle == "splat" and (args.perturb or args.match_color):
        raise SystemExit("--perturb/--match-color need --oracle raycast "
                         "(splat panos are mostly black at capture scales)")
    args.prune_pair = None
    if args.prune:
        k, m = (int(v) for v in args.prune.split(","))
        args.prune_pair = (k, m)
    if args.profile == "omniscenes":
        args.height = args.height or 1024
        args.num_trans, args.num_intermediate, args.init_step = 150, 50, 1
        args.points = args.points or 240000
    else:
        args.height = args.height or 512
        args.num_trans, args.num_intermediate, args.init_step = 50, 20, 2
        args.points = args.points or 60000
    if args.full_rot:
        # the full reference stanford.ini budget keeps the top 50
        args.num_intermediate = 50
    return args


@dataclasses.dataclass
class EvalRoom:
    """One room of the evaluation: its cloud (host and padded on the
    device), clamp box, candidate grids and the plans admitted for it."""

    index: int
    kind: str
    size: tuple
    scene: object  # testing.RoomScene, or None under the splat oracle
    xyz: np.ndarray
    rgb: np.ndarray
    occluders: np.ndarray
    xyz_d: torch.Tensor
    rgb_d: torch.Tensor
    mask_d: torch.Tensor
    lo: np.ndarray
    hi: np.ndarray
    trans_grid: np.ndarray  # padded to a multiple of 64 rows
    rot_grid: np.ndarray
    trans_valid: np.ndarray
    n_trans: int  # real rows of trans_grid
    plan: object = None
    hist_plan: object = None


@dataclasses.dataclass
class EvalQuery:
    """One query: its ground truth and the localize_query inputs."""

    gt_t: np.ndarray
    gt_ypr: np.ndarray
    img_init: torch.Tensor
    img_main: torch.Tensor
    rgb_used: torch.Tensor
    refresh: bool


def _room_cloud(args, ri: int, size, kind: str, rng):
    """(scene, xyz, rgb, occluders) of room ``ri``, drawn from ``rng``."""
    if args.oracle == "raycast":
        scene = make_scene(
            rng, size=size,
            n_occluders=2 + ri % 3 if kind == "cluttered" else 0,
            texture="gradient" if kind == "plain" else "checker",
            floor_at_zero=args.floor_ref,
        )
        xyz, rgb = scene_cloud(scene, rng, args.points)
        if args.realism in ("depth-noise", "holes"):
            # the capture (ray cast) stays ideal, the map degrades: the
            # mismatch real deployments live with
            xyz, rgb = apply_cloud_realism(xyz, rgb, args.realism,
                                           args.realism_val, rng)
        return scene, xyz, rgb, scene.occluders
    if kind == "cluttered":
        xyz, rgb, occ = make_cluttered_room(
            rng, n_per_wall=args.points // 8, size=size,
            n_occluders=2 + ri % 3, n_per_occluder=args.points // 12,
        )
        return None, xyz, rgb, occ
    xyz, rgb = make_room(rng, n_per_wall=args.points // 6, size=size,
                         texture=kind)
    return None, xyz, rgb, np.zeros((0, 2, 3), np.float32)


def _plans(args, room: EvalRoom, dev, first: bool):
    """The JAX script's own admission, with its lines when a plan is
    skipped (its "XLA stage 1" is the port's gather engine): a slab plan
    when its estimate (twice over under --sharpen, whose re-bake the JAX
    program copies) fits the cap, compact when f32 does not; winner-bin
    planes when they fit the cap beside it, never under --sharpen or
    criterion=loss."""
    n_pairs = room.n_trans * room.rot_grid.shape[0]
    n_points = int(room.mask_d.shape[0])
    # ceil: img_init = img_main[::init_step] has ceil(H / step) rows
    hp_h = -(-args.height // args.init_step)
    hp_w = -(-2 * args.height // args.init_step)
    cap = args.slab_cap or default_plan_bytes_cap(dev)
    trans = room.trans_grid[:room.n_trans]
    plan = None
    if not args.no_slab:
        mult = 2 if args.sharpen else 1
        compact = plan_bytes_estimate(n_pairs, n_points) * mult > cap
        if plan_bytes_estimate(n_pairs, n_points, compact=True) * mult > cap:
            if first:
                print("slab plan skipped: sorted streams would crowd "
                      "HBM even compact (XLA stage 1 instead)", flush=True)
        else:
            if compact and first:
                print("using COMPACT slab plan (16 B/sample)", flush=True)
            plan = build_grid_plan(
                room.xyz_d, room.rgb_d, room.mask_d, trans, room.rot_grid,
                hp_h, hp_w, compact=compact,
                # sharpen rebinds cloud colours per query: compact plans
                # must keep point ids so their targets can be re-baked
                tp_is_pid=compact and args.sharpen,
                # table rows bake the seam mode (localize_query refuses a
                # plan of the other mode)
                wrap=args.seam_wrap, device=dev,
            )
    hist_plan = None
    if (not args.no_hist_planes and not args.sharpen
            and args.criterion == "loss_histogram"):
        slab_bytes = plan.nbytes if plan is not None else 0
        if hist_plan_bytes(n_pairs, hp_h, hp_w) + slab_bytes > cap:
            if first:
                print("hist planes skipped: planes + slab plan would "
                      "crowd HBM (live splat instead)", flush=True)
        else:
            hist_plan = build_hist_plan(
                room.xyz_d, room.rgb_d, trans, room.rot_grid, hp_h, hp_w,
                point_mask=room.mask_d, device=dev,
            )
    return plan, hist_plan


def make_eval_room(args, ri: int, rng, dev) -> EvalRoom:
    """Room ``ri``: its cloud, grids and plans, drawing from ``rng`` as the
    JAX script does."""
    size = _ROOM_SIZES[ri % len(_ROOM_SIZES)]
    kind = _KINDS[ri % 3]
    scene, xyz, rgb, occ = _room_cloud(args, ri, size, kind, rng)
    xyz_d, rgb_d, mask_d = _pad_cloud(xyz.astype(np.float32),
                                      rgb.astype(np.float32), dev)
    lo, hi = _order_bounds(xyz, 0.05)
    if args.full_rot:
        # the full reference configs/stanford.ini init budget: a 3-D
        # translation grid and 4x4x4 ypr rotations (deduped)
        init_dict = default_init_dict(
            xy_only=False, num_trans=args.num_trans, yaw_only=False,
            num_yaw=4, num_pitch=4, num_roll=4, z_prior=None,
            num_split_h=4, num_split_w=4,
        )
    else:
        init_dict = default_init_dict(
            xy_only=True, num_trans=args.num_trans, yaw_only=True, num_yaw=8,
            z_prior=1.5 if args.floor_ref else None,
            num_split_h=4, num_split_w=4,
        )
    trans_grid = generate_trans_points(xyz, init_dict)
    rot_grid = generate_rot_points(init_dict)
    n_trans = trans_grid.shape[0]
    pad = (-n_trans) % 64
    trans_valid = np.arange(n_trans + pad) < n_trans
    if pad:
        trans_grid = np.concatenate([trans_grid, np.zeros((pad, 3),
                                                          np.float32)])
    room = EvalRoom(ri, kind, size, scene, xyz, rgb, occ, xyz_d, rgb_d,
                    mask_d, lo, hi, trans_grid, rot_grid, trans_valid,
                    n_trans)
    room.plan, room.hist_plan = _plans(args, room, dev, first=ri == 0)
    return room


def _seam_yaw(room: EvalRoom, gt_t: np.ndarray) -> np.ndarray:
    """The yaw that puts the salient object nearest ``gt_t`` (an occluder's
    centre, else a wall corner) at azimuth +-pi: a world direction at
    azimuth a lands at camera azimuth a + yaw under R = RZ(yaw)."""
    if room.occluders is not None and room.occluders.size:
        centers = room.occluders.mean(axis=1)
    else:
        sx, sy = room.size[0] / 2.0, room.size[1] / 2.0
        centers = np.array(
            [[sx, sy, gt_t[2]], [sx, -sy, gt_t[2]],
             [-sx, sy, gt_t[2]], [-sx, -sy, gt_t[2]]], np.float32)
    d = centers[:, :2] - gt_t[:2]
    tgt = d[int(np.argmin(np.linalg.norm(d, axis=1)))]
    yaw = np.pi - np.arctan2(tgt[1], tgt[0])
    return np.array([(yaw + np.pi) % (2 * np.pi) - np.pi, 0.0, 0.0],
                    np.float32)


def make_eval_query(args, room: EvalRoom, rng, dev) -> EvalQuery:
    """One query of ``room``: a ground-truth pose, its panorama and the
    per-query colour prep, drawing from ``rng`` as the JAX script does."""
    if args.floor_ref:
        gt_t, gt_ypr = scene_pose(room.scene, rng,
                                  yaw_only=not args.full_rot,
                                  z_range=(1.3, 1.7))
    else:
        gt_t, gt_ypr = pose_outside_occluders(rng, room.occluders, room.size,
                                              yaw_only=not args.full_rot)
    if args.seam_gt:
        gt_ypr = _seam_yaw(room, gt_t)
    H, W = args.height, 2 * args.height
    if room.scene is not None:
        # a dense camera-like capture: ray cast, uint8-quantized
        u8 = (raycast_pano(room.scene, gt_t, gt_ypr, (H, W))
              * 255).astype(np.uint8)
        u8 = synth_ablate(
            u8,
            const=args.perturb_val if args.perturb == "const" else None,
            gamma=args.perturb_val if args.perturb == "gamma" else None,
            wb=(0.7, 1.0, 1.3) if args.perturb == "wb" else None,
        )
        if args.realism in ("noise", "jpeg", "blur", "vignette"):
            u8 = apply_image_realism(u8, args.realism, args.realism_val, rng)
        img_f = u8.astype(np.float32) / 255.0
        if args.match_color:
            img_f = color_match(img_f, room.rgb.astype(np.float32))
        img_main = torch.as_tensor(img_f, device=dev)
    else:
        img_main = render_at(room.xyz, room.rgb, gt_t, gt_ypr, (H, W),
                             device=dev)
    s = args.init_step
    img_init = img_main[::s, ::s]
    rgb_used, refresh = room.rgb_d, False
    if args.sharpen:
        # the harness's per-query sharpen prep: joint image + cloud
        # histogram equalization, the cloud's colours rebound, the plan's
        # targets re-baked
        img_init_np, rgb_mod = color_mod(
            img_init.cpu().numpy().astype(np.float32),
            room.rgb.astype(np.float32), 256)
        img_init = torch.as_tensor(img_init_np, device=dev)
        rgb_used = _pad_rgb(rgb_mod, int(room.mask_d.shape[0]), dev)
        refresh = room.plan is not None
    return EvalQuery(gt_t, gt_ypr, img_init, img_main, rgb_used, refresh)


def run_query(args, room: EvalRoom, q: EvalQuery, dev) -> dict:
    """Localize ``q`` and score it: a result row with wall seconds from a
    synchronised start to the winner on the host."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    res = localize_query(
        q.img_init, q.img_main, room.xyz_d, q.rgb_used, room.trans_grid,
        room.rot_grid, room.trans_valid, room.lo, room.hi, room.mask_d,
        num_intermediate=args.num_intermediate, num_input=6, num_iter=100,
        lr=0.1, patience=5, factor=0.8, masked=True, plan=room.plan,
        plan_refresh_rgb=q.refresh, hist_plan=room.hist_plan,
        descent_table=args.descent_table, seam_wrap=args.seam_wrap,
        criterion=args.criterion, descent_prune=args.prune_pair,
        device=dev,
    )
    t = res.t.cpu().numpy()
    elapsed = time.time() - t0
    R = res.rot.cpu().numpy()
    R_gt = rot_from_ypr(torch.as_tensor(q.gt_ypr, dtype=torch.float64)).numpy()
    return dict(room=room.index, kind=room.kind, t_err=translation_error(
        q.gt_t, t), r_err=rotation_error_deg(R_gt, R), sec=elapsed)


def device_label(dev) -> str:
    """``"cpu"``, or the card's ``nvidia-smi`` name and power limit."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index or 0]


def summarize(args, results: List[dict], device: str) -> dict:
    """The JAX script's summary of ``results``, plus ``device``."""
    t_errs = np.array([r["t_err"] for r in results])
    r_errs = np.array([r["r_err"] for r in results])
    n = len(results)
    stanford_ok = np.sum((t_errs < STANFORD_T_THRESH)
                         & (r_errs < STANFORD_R_THRESH_DEG))
    omni_ok = np.sum((t_errs < OMNISCENES_T_THRESH)
                     & (r_errs < OMNISCENES_R_THRESH_DEG))
    by_kind = {}
    for kind in _KINDS:
        sel = [r for r in results if r["kind"] == kind]
        if sel:
            ke = np.array([r["t_err"] for r in sel])
            kr = np.array([r["r_err"] for r in sel])
            by_kind[kind] = dict(
                n=len(sel),
                stanford_acc=float(np.mean((ke < STANFORD_T_THRESH)
                                           & (kr < STANFORD_R_THRESH_DEG))),
                median_t_err=float(np.median(ke)),
            )
    return dict(
        profile=args.profile,
        oracle=args.oracle,
        realism=args.realism,
        realism_val=args.realism_val,
        perturb=args.perturb,
        match_color=bool(args.match_color),
        floor_ref=bool(args.floor_ref),
        full_rot=bool(args.full_rot),
        descent_table=args.descent_table,
        sharpen=bool(args.sharpen),
        seam_gt=bool(args.seam_gt),
        seam_wrap=bool(args.seam_wrap),
        prune=args.prune_pair,
        queries=n,
        stanford_accuracy=float(stanford_ok / n),
        omniscenes_accuracy=float(omni_ok / n),
        median_t_err_m=float(np.median(t_errs)),
        median_r_err_deg=float(np.median(r_errs)),
        median_sec_per_pano=float(np.median([r["sec"] for r in results])),
        by_kind=by_kind,
        device=device,
    )


def main(argv=None) -> dict:
    """Run the evaluation; prints a line a query and the JSON summary, and
    returns the summary."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    enable_compilation_cache()
    rng = np.random.default_rng(args.seed)
    results = []
    for ri in range(args.rooms):
        room = make_eval_room(args, ri, rng, dev)
        for qi in range(args.queries):
            q = make_eval_query(args, room, rng, dev)
            r = run_query(args, room, q, dev)
            results.append(dict(r, query=qi))
            print(f"room {ri} ({room.kind}) q{qi}: t_err={r['t_err']:.4f} m "
                  f"r_err={r['r_err']:.3f} deg  {r['sec']:.2f}s", flush=True)
        del room
    summary = summarize(args, results, device_label(dev))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
