"""Pose errors, success thresholds and the judging of served answers.

The errors and thresholds are a frozen copy of
``piccolo_tpu_torch/harness/metrics.py`` (PICCOLO's ``localize.py:239-258``
and ``:513``): Stanford2D-3D-S counts a pose within 0.2 m and 0.2 rad
(11.46 deg), OmniScenes within 0.1 m and 5 deg.

An answer is judged by the plain reference (``reference.py``): its
*regret* is how far the reference's loss at the served pose lies above the
reference's loss at the reference's own answer to the same request, as a
share of the latter.  A sound answer lands in the same minimum as the
reference's, within a hair; a wrong one lies higher.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from . import reference

STANFORD_T_THRESH = 0.2
STANFORD_R_THRESH_DEG = float(np.rad2deg(0.2))
OMNISCENES_T_THRESH = 0.1
OMNISCENES_R_THRESH_DEG = 5.0


def thresholds(dataset: str):
    if "mni" in dataset:
        return OMNISCENES_T_THRESH, OMNISCENES_R_THRESH_DEG
    return STANFORD_T_THRESH, STANFORD_R_THRESH_DEG


def translation_error(gt, est) -> float:
    return float(np.linalg.norm(np.asarray(gt).ravel()
                                - np.asarray(est).ravel()))


def rotation_error_deg(gt_rot, est_rot) -> float:
    tr = float(np.trace(np.asarray(est_rot).T @ np.asarray(gt_rot)))
    if tr < -1:
        tr = -2 - tr
    elif tr > 3:
        tr = 6 - tr
    return float(np.rad2deg(np.abs(np.arccos((tr - 1) / 2))))


def localized(dataset: str, gt_t, gt_R, t, R) -> bool:
    t_th, r_th = thresholds(dataset)
    return (translation_error(gt_t, t) < t_th
            and rotation_error_deg(gt_R, R) < r_th)


def judge_queries(room: "reference.Room", images: Dict[int, np.ndarray],
                  answers: List[Dict], answer_fn=None) -> Dict:
    """Regret of every answer to each image in ``images``; the reference
    answers each image once.  ``answer_fn(img) -> dict(t, R)`` puts another
    answerer (the control) in the program's place."""
    worst, gaps, n = -math.inf, [], 0
    for i, img in images.items():
        ref = room.localize(img)
        base = room.loss_of(ref["t"], ref["R"], ref["main"], ref["rgb"])
        mine = [a for a in answers if a["image"] == i]
        if answer_fn is not None:
            mine = [dict(answer_fn(img), image=i)]
        for a in mine:
            r = _finite_or_inf(reference.regret(
                room.loss_of(a["t"], a["R"], ref["main"], ref["rgb"]), base))
            worst = max(worst, r)
            gaps.append(translation_error(ref["t"], a["t"]))
            n += 1
    return dict(regret=worst, judged=n,
                t_gap_max_m=max(gaps) if gaps else math.nan)


def judge_tracked(room: "reference.Room", frames: List[Dict],
                  answer_fn=None) -> Dict:
    """Regret of each sampled tracked answer against the reference's
    descent from the same previous pose on the same frame; ``frames`` hold
    the image, the ``prev`` pose sent and the served (t, R)."""
    worst, gaps = -math.inf, []
    prepared: Dict[int, tuple] = {}
    for fr in frames:
        key = fr["image_key"]
        if key not in prepared:
            prepared[key] = reference.main_image_only(room, fr["img"])
        main, rgb = prepared[key]
        ref = room.track(fr["img"], fr["prev"]["t"], fr["prev"]["ypr"],
                         main=main, rgb=rgb)
        base = room.loss_of(ref["t"], ref["R"], main, rgb)
        ans = fr if answer_fn is None else answer_fn(fr, main, rgb)
        worst = max(worst, _finite_or_inf(reference.regret(
            room.loss_of(ans["t"], ans["R"], main, rgb), base)))
        gaps.append(translation_error(ref["t"], ans["t"]))
    return dict(regret=worst, judged=len(frames),
                t_gap_max_m=max(gaps) if gaps else math.nan)


def _finite_or_inf(r: float) -> float:
    """An answer whose loss is not a number (a NaN pose) is as wrong as an
    answer can be."""
    return r if math.isfinite(r) else math.inf
