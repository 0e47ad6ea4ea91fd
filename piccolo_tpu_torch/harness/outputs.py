"""Result artifacts: CSV rows, TensorBoard scalars, result images, GIFs
(a copy of piccolo_tpu/harness/outputs.py; PNGs and GIFs go through the
port's own writers).

Output schemas are identical to the reference so downstream tooling works
unchanged: CSV columns (``localize.py:132,346``), flattened-array cell
format, ``results/``/``gifs/``/``starting_points/`` image trees, TensorBoard
scalar/text channels.  One fix: the per-step scalar summaries actually clear
after each write (the reference's reset rebinds a local and accumulates
forever — ``utils.py:455-459``).
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np

from .gif import encode_gif
from .imaging import imwrite_rgb, resize, vconcat

__all__ = ["fmt_array", "CsvSummary", "ScalarSummaries", "save_result_image", "save_gif"]

STANFORD_COLUMNS = [
    "area_num", "pano_name", "gt_trans", "gt_rot", "skipped?",
    "OmniLoc_trans", "OmniLoc_rot", "t_error (m)", "r_error (degrees)",
    "time (s)",
]
OMNISCENES_COLUMNS = [
    "pano_name", "gt_trans", "gt_rot", "skipped?",
    "OmniLoc_trans", "OmniLoc_rot", "t_error (m)", "r_error (degrees)",
    "time (s)",
]


def fmt_array(a: np.ndarray) -> str:
    """The reference's CSV cell format: str(flat)[1:-1] without newlines."""
    return str(np.asarray(a).flatten())[1:-1].replace("\n", "")


class CsvSummary:
    """Append-per-query CSV writer with optional resume.

    Partial results survive crashes because every query is flushed
    immediately; with ``resume=True`` an existing file is scanned and its
    pano names are reported via ``done`` so the harness can skip them
    (checkpoint/resume — absent in the reference, SURVEY §5).
    """

    def __init__(self, path: str, columns: Sequence[str], resume: bool = False):
        self.path = path
        self.columns = list(columns)
        self.done = set()
        name_idx = self.columns.index("pano_name")
        exists = os.path.exists(path)
        if resume and exists:
            with open(path, newline="", encoding="utf-8") as f:
                for i, row in enumerate(csv.reader(f)):
                    if i == 0 or len(row) <= name_idx:
                        continue
                    self.done.add(row[name_idx])
            self._fh = open(path, "a", encoding="utf-8", newline="")
            self._writer = csv.writer(self._fh)
        else:
            self._fh = open(path, "w", encoding="utf-8", newline="")
            self._writer = csv.writer(self._fh)
            self._writer.writerow(self.columns)
            self._fh.flush()

    def write(self, row: List) -> None:
        self._writer.writerow(row)
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class ScalarSummaries:
    """Mean-per-step scalar aggregation for TensorBoard (utils.py:455-459)."""

    def __init__(self, writer=None):
        self.writer = writer
        self._values = defaultdict(list)

    def add(self, key: str, value: float) -> None:
        self._values[key].append(float(value))

    def add_text(self, key: str, text: str) -> None:
        if self.writer is not None:
            self.writer.add_text(key, text)

    def write(self, step: int) -> None:
        if self.writer is not None:
            for k, v in self._values.items():
                self.writer.add_scalar(k, float(np.mean(v)), step)
        self._values = defaultdict(list)

    def write_scalar(self, key: str, value: float, step: Optional[int] = None):
        if self.writer is not None:
            if step is None:
                self.writer.add_scalar(key, value)
            else:
                self.writer.add_scalar(key, value, step)


def save_result_image(
    path: str, gt_img_u8: np.ndarray, rendered_u8: np.ndarray
) -> None:
    """GT pano stacked over the best-pose projected pano (localize.py:276-279)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    gt = resize(gt_img_u8, (rendered_u8.shape[1], rendered_u8.shape[0]))
    imwrite_rgb(path, vconcat(gt, rendered_u8))


def save_gif(path: str, frames_u8: List[np.ndarray], duration_ms: int = 150) -> None:
    """Optimisation GIF from per-iteration frames (localize.py:281-288),
    written by the port's own GIF writer (``gif.py``: one fixed 256-colour
    palette, LZW)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # Reference pads the first frame 4 extra times and appends hold frames.
    frames = frames_u8[:1] * 4 + list(frames_u8) + frames_u8[-1:] * 5
    with open(path, "wb") as f:
        f.write(encode_gif(frames, duration_ms))
