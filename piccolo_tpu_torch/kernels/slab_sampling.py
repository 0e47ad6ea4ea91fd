"""Stage-1 candidate-grid scoring from room-static sorted sample streams.

Port of piccolo_tpu/kernels/slab_sampling.py in its three plan layouts.
Stage-1 sample locations depend only on the room (cloud + candidate grid),
so the plan computes every (pair, point) -> (table row, bilinear fractions)
once, sorts each 128-pair group's samples by table row and pads them into
blocks that each lie inside one aligned table window.  Per query, one
launch of the CUDA kernel of ``csrc/slab_sampling.cu`` scores a group's
blocks against their windows of the packed sampling table and returns the
group's sums, in every layout, re-baking targets from point ids itself
when the query rebinds the colours.  A ``*_plain`` function beside each
wrapper is the same function in plain PyTorch.

The plans keep the JAX package's stream layouts, so plans compare field for
field and a JAX-built plan runs here unchanged
(``convert.grid_plan_from_numpy``):

* f32: (NB, 8, BLOCK) f32 fields [lidx, wx1, wy1, r, g, b, cid, pid];
* compact: (NB, 3, BLOCK) f32 [lidx*128 + cid, wx1, wy1] plus a split
  (NB, 1, BLOCK) f32 ``tps`` stream holding the target as a 24-bit integer
  r<<16|g<<8|b, or the point id for refresh-capable plans (``tp_is_pid``);
* q8: (NB, 1, BLOCK) int32 lidx(9)|cid(7)|wx(8)|wy(8), pad lidx = 511,
  plus the same ``tps`` stream;

each with (NB,) int32 windows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor, on_card, resolve_device
from ..loss import Pose, transform_cloud
from ..ops.projection import safe_norm, spherical_project
from ..ops.sampling import pack_bilinear_blocks, packed_rows_and_weights
from ._build import count_launch, load_library, on_device

__all__ = [
    "GridPlan",
    "PlanOverBudget",
    "make_pairs",
    "build_grid_plan",
    "slab_table",
    "slab_block_partials_plain",
    "slab_block_partials_compact_plain",
    "slab_block_partials_q8_plain",
    "slab_group_sums_f32",
    "slab_group_sums_f32_plain",
    "slab_group_sums_compact",
    "slab_group_sums_compact_plain",
    "slab_group_sums_q8",
    "slab_group_sums_q8_plain",
    "slab_group_partials",
    "slab_pair_scores",
    "plan_group_sums",
    "plan_required_blocks",
    "nb_bucket",
    "plan_bytes_estimate",
    "slab_worthwhile",
    "default_plan_bytes_cap",
    "plan_exact_bytes",
    "resolve_plan_geometry",
    "pack_rgb24",
    "WINDOW",
    "BLOCK",
    "GROUP",
]

WINDOW = 512  # default table rows per aligned window (see the resolver)
BLOCK = 1024  # default samples per plan block
GROUP = 128  # candidate pairs per group (the kernel's accumulator width)

# field order in the f32 plan's packed (8, BLOCK) sample block
_F_LIDX, _F_WX1, _F_WY1, _F_TR, _F_TG, _F_TB, _F_CID, _F_PID = range(8)

# q8 pad: lidx = 511 names no row of a window <= 256; as int32 the bit
# pattern 0xFF800000 (shifted on an int32 tensor, so it wraps like JAX's)
_Q8_PAD_LIDX = 511
_Q8_MAX_WINDOW = 256


# resolve_plan_geometry's density split (points a table row) between
# (128, 1024) and (256, 512) on the card.  H100 80GB HBM3, 700 W
# (scripts/measure_admission.py, PERF.md's routing-values table,
# row 4), group-sum device time: (128, 1024) wins every layout, re-bake or
# not, at densities 0.46 and 2.0 (5-27% less time); (256, 512) wins 17 of
# 18 cases at 0.031 and 0.0078 (its plan holds a half or a third of the
# slots); at 0.125 (the Stanford CLI's 1024x512 init image) (128, 1024)
# takes 7% less summed over the six layouts in two rooms, 9-10% less on the
# shipped config's f32 re-bake, and loses 2-5% on f32 and compact without
# it.  The JAX package splits at 0.25.
_CARD_DENSITY_SPLIT = 1.0 / 16.0


def resolve_plan_geometry(n_points: int, height: int, width: int,
                          window=None, block=None, device=None):
    """(window, block) for a plan: (128, 1024) for dense tables, else
    (256, 512); explicit values override.  Dense is at least 0.25 points a
    table row, the JAX package's rule, or on a CUDA ``device`` at least
    ``_CARD_DENSITY_SPLIT``."""
    if window is None and block is None:
        density = n_points / float(_table_rows(height, width))
        split = _CARD_DENSITY_SPLIT if on_card(device) else 0.25
        return (128, 1024) if density >= split else (256, 512)
    return (int(window or WINDOW), int(block or BLOCK))


DEFAULT_PLAN_BYTES_CAP = 9 * 10**9
# the plan budget's share of the card, the JAX package's 9/16.  H100 80GB
# HBM3, 700 W (scripts/measure_admission.py, PERF.md's routing-values
# table, row 3): outside the plan a query peaks at 1.6-2.9 GB and a plan
# build at 2.5 GB (60,000 points) and 23.2 GB (the 1.02 M-point stretch
# room), so a plan at the 47.8 GB cap peaks at 71.0 of the card's 85.0 GB,
# 14 GB of headroom; 10/16 would leave 8.7 GB
_PLAN_MEM_FRACTION = 9.0 / 16.0


def default_plan_bytes_cap(device=None) -> int:
    """Budget for a plan's streams: ``_PLAN_MEM_FRACTION`` of the card's
    memory.  ``None`` means the current CUDA device when one is present (as
    JAX takes its default device); off the card, the fixed 9 GB default."""
    if device is None:
        if not torch.cuda.is_available():
            return DEFAULT_PLAN_BYTES_CAP
        _, total = torch.cuda.mem_get_info()
    else:
        dev = torch.device(device)
        if dev.type != "cuda":
            return DEFAULT_PLAN_BYTES_CAP
        _, total = torch.cuda.mem_get_info(dev)
    return int(total * _PLAN_MEM_FRACTION)


class PlanOverBudget(RuntimeError):
    """The exact plan size (known after the sizing pass) exceeds the cap."""

    def __init__(self, exact_bytes: int, cap: int):
        super().__init__(
            f"slab plan needs {exact_bytes / 1e9:.2f} GB (cap {cap / 1e9:.2f} GB)"
        )
        self.exact_bytes = exact_bytes
        self.cap = cap


def _bytes_per_sample(compact: bool, quant: bool) -> int:
    return 8 if quant else (16 if compact else 32)


def plan_exact_bytes(n_groups: int, nb: int, compact: bool,
                     block: int = BLOCK, quant: bool = False) -> int:
    """Exact footprint of a plan once the padded block count is known:
    32, 16 or 8 B a sample slot (f32, compact, q8) plus the windows."""
    return n_groups * (nb * block * _bytes_per_sample(compact, quant) + nb * 4)


def plan_bytes_estimate(n_pairs: int, n_points: int, compact: bool = False,
                        quant: bool = False) -> int:
    """Footprint of a plan before building it, with ~25% block padding."""
    groups = (n_pairs + GROUP - 1) // GROUP
    return int(groups * GROUP * n_points * _bytes_per_sample(compact, quant)
               * 1.25)


# slab_worthwhile on the card: wall seconds a pair-point at init tables of
# _CARD_TABLE_MB.  H100 80GB HBM3, 700 W (scripts/measure_admission.py,
# PERF.md's routing-values table, row 1), 65,536-point clouds:
# the gather engine at its chunk (gather_chunk: 64), the fastest seen; the
# slab kernel a pair-point of whole 128-pair groups at the resolved
# geometry, the slowest seen, f32 or the slower of compact and q8, without
# and with the fused re-bake.  The plan wins 27-76x; the 0.7 margin is the
# JAX package's
_CARD_TABLE_MB = (6.3, 25.2, 100.8, 402.9)
_CARD_GATHER_S = (1.146e-9, 1.130e-9, 1.137e-9, 1.169e-9)
_CARD_SLAB_S = {  # (compact, refresh)
    (False, False): (1.50e-11, 1.52e-11, 2.06e-11, 4.30e-11),
    (False, True): (1.58e-11, 1.78e-11, 2.13e-11, 3.85e-11),
    (True, False): (1.58e-11, 2.09e-11, 1.83e-11, 3.23e-11),
    (True, True): (1.58e-11, 1.79e-11, 2.15e-11, 3.64e-11),
}


def slab_worthwhile(n_pairs: int, n_points: int, height: int, width: int,
                    refresh: bool, compact: bool = False,
                    device=None) -> bool:
    """Whether a plan and its kernel (with the per-query target re-bake
    that sharpen_color forces) beat the gather engine for stage 1.  On a
    CUDA ``device``: the card's measured rates (``_CARD_*``).  Elsewhere:
    the JAX package's cost model and rates, so the ladder equals the JAX
    package's."""
    table_mb = _table_rows(height, width) * 48 / 1e6
    groups = (n_pairs + GROUP - 1) // GROUP
    if on_card(device):
        gather_s = float(np.interp(table_mb, _CARD_TABLE_MB, _CARD_GATHER_S))
        slab_s = float(np.interp(table_mb, _CARD_TABLE_MB,
                                 _CARD_SLAB_S[(bool(compact),
                                               bool(refresh))]))
        return (groups * GROUP * n_points * slab_s
                < 0.7 * n_pairs * n_points * gather_s)
    gather_rate = float(np.interp(table_mb, [6.0, 25.0, 100.0],
                                  [2.7e8, 1.1e8, 4.5e7]))
    samples = groups * GROUP * n_points * 1.25
    gather_cost = n_pairs * n_points / gather_rate
    refresh_gathers = (1 if compact else 3) if refresh else 0
    slab_cost = samples / 7.5e8 + refresh_gathers * samples / 2.7e8
    return slab_cost < 0.7 * gather_cost


@dataclasses.dataclass
class GridPlan:
    """Room-static sorted sample streams for :func:`slab_pair_scores`.

    fields:  per-group sample blocks in the layout the flags name (module
             docstring); padding slots contribute nothing.
    windows: per-group (NB,) int32 aligned table-window index per block.
    n_pairs: leading candidate pairs the plan covers (pairs beyond it are
             the consumer's to mask).
    height/width: the init-image shape the table rows were computed for.
    tps:     per-group (NB, 1, BLOCK) f32 target/pid streams (compact and
             q8 plans; empty for f32 plans).
    """

    fields: Tuple[torch.Tensor, ...]
    windows: Tuple[torch.Tensor, ...]
    n_pairs: int
    height: int
    width: int
    wrap: bool = False
    window: int = WINDOW
    block: int = BLOCK
    compact: bool = False
    tp_is_pid: bool = False
    quant: bool = False
    tps: Tuple[torch.Tensor, ...] = ()

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.fields + self.windows + tuple(self.tps))


def make_pairs(trans_grid: torch.Tensor, rot_grid: torch.Tensor):
    """Flattened trans-major (t, ypr) pairs: the stage-1 candidate order."""
    T, R = trans_grid.shape[0], rot_grid.shape[0]
    return (torch.repeat_interleave(trans_grid, R, dim=0),
            rot_grid.repeat(T, 1))


def _table_rows(height: int, width: int) -> int:
    return (height + 1) * (width + 1)


def _rpad(height: int, width: int, window: int = WINDOW) -> int:
    rows = _table_rows(height, width)
    return ((rows + window - 1) // window) * window


def nb_bucket(n: int) -> int:
    """Geometric block-count buckets (the JAX package's shape reuse)."""
    b = 256
    while b < n:
        if b * 3 // 2 >= n:
            return b * 3 // 2
        b *= 2
    return b


def _project_group(xyz, point_mask, t_g, ypr_g, height, width, wrap=False):
    """(row, wx1, wy1), each (G, N), for G candidate poses: the query
    path's geometry, so floors and fractions match the gather engine.
    Masked-out points land on row 0 (the zero border) with zero fractions."""
    pose = Pose(t=t_g, yaw=ypr_g[:, 0], pitch=ypr_g[:, 1], roll=ypr_g[:, 2])
    coords = spherical_project(transform_cloud(pose, xyz))
    row, wx1, wy1 = packed_rows_and_weights(coords, height, width, wrap=wrap)
    if point_mask is not None:
        row = torch.where(point_mask[None], row, torch.zeros_like(row))
        wx1 = torch.where(point_mask[None], wx1, torch.zeros_like(wx1))
        wy1 = torch.where(point_mask[None], wy1, torch.zeros_like(wy1))
    return row, wx1, wy1


def _blocks_needed(row: torch.Tensor, n_win: int, window: int,
                   block: int) -> int:
    """Padded block count of one group's rows (window histogram, no sort)."""
    counts = torch.bincount(row.reshape(-1).to(torch.int64) // window,
                            minlength=n_win)
    return int(((counts + block - 1) // block).sum())


def pack_rgb24(rgb: torch.Tensor) -> torch.Tensor:
    """(N, 3) colours in [0, 1] -> (N,) f32 exact 24-bit ints r<<16|g<<8|b."""
    q = torch.round(rgb.clamp(0.0, 1.0) * 255.0)
    return q[:, 0] * 65536.0 + q[:, 1] * 256.0 + q[:, 2]


def _q8_pad(device) -> torch.Tensor:
    return torch.tensor(_Q8_PAD_LIDX, dtype=torch.int32, device=device) << 23


def _layout_group(row, wx1, wy1, rgb, *, nb: int, n_win: int, window: int,
                  block: int, compact: bool = False, tp_is_pid: bool = False,
                  quant: bool = False):
    """Sorted, window-padded sample blocks of one group from its projected
    (G, N) rows and fractions: the layout half of the JAX package's
    ``_plan_group``.  Returns (fields, (nb,) int32 windows, tps or None)."""
    G, N = row.shape
    dev = row.device
    cid = torch.arange(G, dtype=torch.float32, device=dev)[:, None].expand(G, N)
    pid = torch.arange(N, dtype=torch.float32, device=dev)[None].expand(G, N)
    if compact or quant:
        tp1 = pid if tp_is_pid else pack_rgb24(rgb)[None].expand(G, N)
    if quant:
        # cid|wx|wy packed into one int32 BEFORE the sort, as JAX does it;
        # torch.round and jnp.round both round half to even
        cid_i = torch.arange(G, dtype=torch.int32, device=dev)[:, None]
        pp = ((cid_i.expand(G, N) << 16)
              | (torch.round(wx1 * 255.0).to(torch.int32) << 8)
              | torch.round(wy1 * 255.0).to(torch.int32))
        payloads = (pp, tp1)
    elif compact:
        payloads = (wx1, wy1, cid, tp1)
    else:
        tgt = rgb.T[:, None, :].expand(3, G, N)
        payloads = (wx1, wy1, tgt[0], tgt[1], tgt[2], cid, pid)

    # stable sort by row, payloads follow the permutation (jax.lax.sort)
    row_s, perm = torch.sort(row.reshape(-1).to(torch.int64), stable=True)
    vals = [x.reshape(-1)[perm] for x in payloads]

    win = row_s // window
    edges = torch.arange(n_win + 1, dtype=torch.int64, device=dev) * window
    starts = torch.searchsorted(row_s, edges, side="left")
    blocks_w = (torch.diff(starts) + block - 1) // block
    block_off = torch.cumsum(blocks_w, 0) - blocks_w
    i = torch.arange(row_s.shape[0], dtype=torch.int64, device=dev)
    positions = i - starts[win] + block_off[win] * block
    windows = torch.zeros(nb, dtype=torch.int32, device=dev)
    windows.scatter_reduce_(0, positions // block, win.to(torch.int32), "amax",
                            include_self=True)

    tps = None
    if compact or quant:
        tps = torch.zeros(nb * block, dtype=torch.float32, device=dev)
        tps.index_put_((positions,), vals[-1])
        tps = tps.reshape(nb, 1, block)
    if quant:
        li = (row_s - win * window).to(torch.int32)
        g = (li << 23) | vals[0]
        flat = _q8_pad(dev).expand(nb * block).clone()
        flat.index_put_((positions,), g)
        return flat.reshape(nb, 1, block), windows, tps

    lidx = (row_s - win * window).to(torch.float32)
    if compact:
        # lc = lidx*128 + cid, exact small ints in f32; pad lc = -1 floors
        # to lidx = -1, which the kernel skips
        payload = torch.stack([lidx * float(GROUP) + vals[2], vals[0],
                               vals[1]], dim=-1)
        empty = [-1, 0, 0]
    else:
        payload = torch.stack([lidx] + vals, dim=-1)  # (M, 8)
        # pads: lidx = cid = -1 select no table row and no pair
        empty = [-1, 0, 0, 0, 0, 0, -1, 0]
    nf = len(empty)
    flat = torch.tensor(empty, dtype=torch.float32, device=dev).expand(
        nb * block, nf).clone()
    flat.index_put_((positions,), payload)
    fields = flat.reshape(nb, block, nf).transpose(1, 2).contiguous()
    return fields, windows, tps


def _padded_pairs(trans_grid, rot_grid):
    pair_t, pair_r = make_pairs(trans_grid, rot_grid)
    P = pair_t.shape[0]
    pad = (-P) % GROUP
    if pad:
        pair_t = torch.cat([pair_t, pair_t[:1].expand(pad, 3)])
        pair_r = torch.cat([pair_r, pair_r[:1].expand(pad, 3)])
    return pair_t, pair_r, P


def _room_inputs(xyz, point_mask, trans_grid, rot_grid, dev):
    xyz = as_tensor(xyz, dev, torch.float32)
    pm = None if point_mask is None else as_tensor(point_mask, dev, torch.bool)
    pair_t, pair_r, P = _padded_pairs(as_tensor(trans_grid, dev, torch.float32),
                                      as_tensor(rot_grid, dev, torch.float32))
    return xyz, pm, pair_t, pair_r, P


def _group_projector(xyz, pm, pair_t, pair_r, height, width, wrap):
    def project(g):
        sl = slice(g * GROUP, (g + 1) * GROUP)
        return _project_group(xyz, pm, pair_t[sl], pair_r[sl], height, width,
                              wrap)

    return project


def plan_required_blocks(xyz, point_mask, trans_grid, rot_grid, height: int,
                         width: int, wrap: bool = False, window=None,
                         block=None, device="cuda") -> int:
    """Raw (pre-bucket) maximum padded block count over the plan's groups;
    the harness rounds it tighter than :func:`nb_bucket` when a bucketed
    compact plan misses its budget."""
    dev = resolve_device(device)
    xyz, pm, pair_t, pair_r, _ = _room_inputs(xyz, point_mask, trans_grid,
                                              rot_grid, dev)
    window, block = resolve_plan_geometry(xyz.shape[0], height, width,
                                          window, block, device=dev)
    n_win = _rpad(height, width, window) // window
    project = _group_projector(xyz, pm, pair_t, pair_r, height, width, wrap)
    return max(_blocks_needed(project(g)[0], n_win, window, block)
               for g in range(pair_t.shape[0] // GROUP))


def build_grid_plan(xyz, rgb, point_mask, trans_grid, rot_grid, height: int,
                    width: int, compact: bool = False, tp_is_pid: bool = False,
                    bytes_cap: Optional[int] = None, nb: Optional[int] = None,
                    wrap: bool = False, window: Optional[int] = None,
                    block: Optional[int] = None, quant: bool = False,
                    device="cuda",
                    groups: Optional[Tuple[int, int]] = None) -> GridPlan:
    """Build the room-static sorted sample streams (once per room and
    init-image size), in the f32 layout, or compact (``compact``) or q8
    (``compact`` and ``quant``) with targets or, under ``tp_is_pid``, point
    ids in the split ``tps`` stream.

    ``trans_grid`` should hold only the real (unpadded) rows.  A sizing
    pass fixes the bucketed block count unless ``nb`` forces it;
    ``bytes_cap`` then raises :class:`PlanOverBudget` before any stream is
    built.  Groups are built one after another, so peak memory stays about
    one group above the plan.  ``groups=(first, stop)`` builds only those
    groups (a mesh shard's slice); the plan still names every pair in
    ``n_pairs``.
    """
    if quant and not compact:
        raise ValueError("quant=True is a sub-mode of compact plans "
                         "(pass compact=True)")
    dev = resolve_device(device)
    xyz, pm, pair_t, pair_r, P = _room_inputs(xyz, point_mask, trans_grid,
                                              rot_grid, dev)
    rgb = as_tensor(rgb, dev, torch.float32)
    n_groups = pair_t.shape[0] // GROUP
    window, block = resolve_plan_geometry(xyz.shape[0], height, width,
                                          window, block, device=dev)
    if quant and window > _Q8_MAX_WINDOW:
        raise ValueError(
            "q8 plans need window <= 256 (the 9-bit lidx field's sentinel "
            f"511 must never name a real row), got {window}")
    n_win = _rpad(height, width, window) // window
    project = _group_projector(xyz, pm, pair_t, pair_r, height, width, wrap)

    if nb is None:
        nb = nb_bucket(max(_blocks_needed(project(g)[0], n_win, window, block)
                            for g in range(n_groups)))
    first, stop = (0, n_groups) if groups is None else groups
    if bytes_cap is not None:
        exact = plan_exact_bytes(stop - first, nb, compact, block, quant=quant)
        if exact > bytes_cap:
            raise PlanOverBudget(exact, bytes_cap)
    fields, windows, tps = [], [], []
    for g in range(first, stop):
        f, w, t = _layout_group(*project(g), rgb, nb=nb, n_win=n_win,
                                window=window, block=block, compact=compact,
                                tp_is_pid=tp_is_pid, quant=quant)
        fields.append(f)
        windows.append(w)
        if t is not None:
            tps.append(t)
    return GridPlan(fields=tuple(fields), windows=tuple(windows), n_pairs=P,
                    height=height, width=width, wrap=wrap, window=window,
                    block=block, compact=compact, tp_is_pid=tp_is_pid,
                    quant=quant, tps=tuple(tps))


def slab_table(img: torch.Tensor, wrap: bool = False,
               window: int = WINDOW) -> torch.Tensor:
    """The kernel's table: the packed bilinear table as contiguous f32
    (rp, 12), rows zero-padded to a multiple of the window."""
    H, W, _ = img.shape
    blocks = pack_bilinear_blocks(img.to(torch.float32), wrap=wrap)
    pad = _rpad(H, W, window) - blocks.shape[0]
    if pad:
        blocks = torch.cat([blocks, blocks.new_zeros(pad, 12)])
    return blocks.contiguous()


# ---- plain versions: decode a layout, then one shared scorer -------------


def _partials_plain(table, windows, window, li, x1, y1, tgt, cid, ok):
    """(NB, 2, 128) per-block loss sums and valid counts per pair id from
    decoded (NB, block) samples; ``tgt`` is (NB, block, 3)."""
    nb = li.shape[0]
    rows = windows.to(torch.int64)[:, None] * window + torch.where(
        ok, li, torch.zeros_like(li))
    v = table[rows]  # (NB, block, 12)
    x1 = x1[..., None]
    y1 = y1[..., None]
    x0 = 1.0 - x1
    y0 = 1.0 - y1
    # same tap/term order as ops.sampling.bilinear_sample_packed
    s = (v[..., 0:3] * (x0 * y0) + v[..., 3:6] * (x1 * y0)
         + v[..., 6:9] * (x0 * y1) + v[..., 9:12] * (x1 * y1))
    valid = ((s == 0.0).sum(-1) != 3) & ok
    per = safe_norm(s - tgt)
    out = torch.zeros((nb, 2, GROUP), dtype=torch.float32, device=li.device)
    c = torch.where(ok, cid, torch.zeros_like(cid))
    out[:, 0].scatter_add_(1, c, per * valid)
    out[:, 1].scatter_add_(1, c, valid.to(torch.float32))
    return out


def _unpack_targets(tp: torch.Tensor) -> torch.Tensor:
    """(NB, block) 24-bit packed targets -> (NB, block, 3) rgb in [0, 1]:
    exact power-of-two splits, then an IEEE division by 255."""
    tr = torch.floor(tp * (1.0 / 65536.0))
    rem = tp - tr * 65536.0
    tg = torch.floor(rem * (1.0 / 256.0))
    tb = rem - tg * 256.0
    return torch.stack([tr, tg, tb], dim=-1) / 255.0


def slab_block_partials_plain(table: torch.Tensor, fields: torch.Tensor,
                              windows: torch.Tensor,
                              window: int) -> torch.Tensor:
    """(NB, 2, 128) per-block loss sums and valid counts per pair id of an
    f32 plan group."""
    li = fields[:, _F_LIDX].to(torch.int64)
    cid = fields[:, _F_CID].to(torch.int64)
    return _partials_plain(table, windows, window, li, fields[:, _F_WX1],
                           fields[:, _F_WY1],
                           fields[:, _F_TR:_F_TB + 1].transpose(1, 2), cid,
                           (li >= 0) & (cid >= 0))


def slab_block_partials_compact_plain(table: torch.Tensor,
                                      fields: torch.Tensor, tps: torch.Tensor,
                                      windows: torch.Tensor,
                                      window: int) -> torch.Tensor:
    """:func:`slab_block_partials_plain` of a compact plan group: decode
    lc = lidx*128 + cid by power-of-two scalings (exact); pads have
    lidx < 0."""
    lc = fields[:, 0]
    lif = torch.floor(lc * (1.0 / GROUP))
    cid = (lc - lif * float(GROUP)).to(torch.int64)
    li = lif.to(torch.int64)
    return _partials_plain(table, windows, window, li, fields[:, 1],
                           fields[:, 2], _unpack_targets(tps[:, 0]), cid,
                           li >= 0)


def slab_block_partials_q8_plain(table: torch.Tensor, fields: torch.Tensor,
                                 tps: torch.Tensor, windows: torch.Tensor,
                                 window: int) -> torch.Tensor:
    """:func:`slab_block_partials_plain` of a q8 plan group: unpack
    lidx(9)|cid(7)|wx(8)|wy(8), fractions times the f32 reciprocal of 255;
    pads have lidx = 511 >= window."""
    g = fields[:, 0]
    li = ((g >> 23) & 0x1FF).to(torch.int64)
    cid = ((g >> 16) & 0x7F).to(torch.int64)
    x1 = ((g >> 8) & 0xFF).to(torch.float32) * (1.0 / 255.0)
    y1 = (g & 0xFF).to(torch.float32) * (1.0 / 255.0)
    return _partials_plain(table, windows, window, li, x1, y1,
                           _unpack_targets(tps[:, 0]), cid, li < window)


def _group_sums_plain(block_partials, table, fields, tps, windows, window,
                      palette):
    if palette is not None:
        tps = palette[tps.to(torch.int64)]
    out = block_partials(table, fields, tps, windows, window)
    return out[:, 0].sum(0), out[:, 1].sum(0)


def slab_group_sums_compact_plain(table: torch.Tensor, fields: torch.Tensor,
                                  tps: torch.Tensor, windows: torch.Tensor,
                                  window: int,
                                  palette: Optional[torch.Tensor] = None):
    """(loss_sum, valid_count), each (128,), of a compact plan group: the
    per-block partials summed over blocks.  With ``palette`` (the packed
    colours, :func:`pack_rgb24`) ``tps`` holds point ids, and the targets
    are re-baked by one gather first."""
    return _group_sums_plain(slab_block_partials_compact_plain, table, fields,
                             tps, windows, window, palette)


def slab_group_sums_q8_plain(table: torch.Tensor, fields: torch.Tensor,
                             tps: torch.Tensor, windows: torch.Tensor,
                             window: int,
                             palette: Optional[torch.Tensor] = None):
    """:func:`slab_group_sums_compact_plain` of a q8 plan group."""
    return _group_sums_plain(slab_block_partials_q8_plain, table, fields, tps,
                             windows, window, palette)


def slab_group_sums_f32_plain(table: torch.Tensor, fields: torch.Tensor,
                              windows: torch.Tensor, window: int,
                              rgb: Optional[torch.Tensor] = None):
    """(loss_sum, valid_count), each (128,), of an f32 plan group: the
    per-block partials summed over blocks.  With ``rgb`` ((N, 3) colours,
    or their zero-padded (N, 4) copy) the r, g and b rows are first
    re-baked from the pid row by one gather into a copy of the group."""
    if rgb is not None:
        pids = fields[:, _F_PID].to(torch.int64)
        fields = fields.clone()
        fields[:, _F_TR:_F_TB + 1] = rgb[pids][..., :3].permute(0, 2, 1)
    out = slab_block_partials_plain(table, fields, windows, window)
    return out[:, 0].sum(0), out[:, 1].sum(0)


# ---- kernel wrappers -----------------------------------------------------

# the kernel's layout codes (csrc/slab_sampling.cu)
_COMPACT, _Q8, _F32 = 0, 1, 2


@functools.cache
def _sums_launcher():
    fn = load_library("slab_sampling").slab_sums_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _max_ctas(device_index: int, layout: int, pid: bool, window: int) -> int:
    """CTAs of the group-sum kernel that the card holds at once."""
    fn = load_library("slab_sampling").slab_sums_max_ctas
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    ctas = ctypes.c_int(0)
    with on_device(torch.device("cuda", device_index)):
        err = fn(layout, int(pid), window, ctypes.byref(ctas))
    if err != 0 or ctas.value == 0:
        raise ValueError(f"the group-sum kernel cannot stage a window of "
                         f"{window} rows on this card (CUDA error {err})")
    return ctas.value


_MAX_SUM_WINDOW = 2048  # two windows + accumulators in 227 KB
_SUM_CHUNK = 2  # plan blocks a CTA of the group-sum kernel takes at a time


def _check(table, fields, tps, windows, window, nf, field_dtype, name,
           palette=None):
    """Shapes, dtypes and devices of a wrapper call; True when the call
    runs on the card."""
    if table.dim() != 2 or table.shape[1] != 12 or table.shape[0] % window:
        raise ValueError(f"table must be (rp, 12) with rp a multiple of "
                         f"{window}, got {tuple(table.shape)}")
    if fields.dim() != 3 or fields.shape[1] != nf:
        raise ValueError(f"{name}: fields must be (NB, {nf}, block), got "
                         f"{tuple(fields.shape)}")
    if windows.shape != (fields.shape[0],):
        raise ValueError("windows must be (NB,)")
    tensors = [table, fields, windows]
    dtypes = [torch.float32, field_dtype, torch.int32]
    if tps is not None:
        if tps.shape != (fields.shape[0], 1, fields.shape[2]):
            raise ValueError("tps must be (NB, 1, block)")
        tensors.append(tps)
        dtypes.append(torch.float32)
    if palette is not None:
        tensors.append(palette)
        dtypes.append(torch.float32)
    if [t.dtype for t in tensors] != dtypes:
        raise TypeError(f"{name}: need dtypes {dtypes}, got "
                        f"{[t.dtype for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("table, fields, tps, palette and windows must be on "
                         "one device")
    if fields.device.type == "cpu":
        return False
    if fields.device.type != "cuda":
        raise ValueError(f"unsupported device {fields.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("table, fields, tps, palette and windows must be "
                         "contiguous")
    if not 0 < window <= _MAX_SUM_WINDOW:
        raise ValueError(f"window must be in (0, {_MAX_SUM_WINDOW}]")
    return True


def _rgb4(rgb: torch.Tensor) -> torch.Tensor:
    """(N, 3) colours -> their (N, 4) copy with a zero fourth column: the
    f32 kernel's palette, one 16-byte load a target."""
    return torch.nn.functional.pad(rgb, (0, 1))


def _group_sums(wrapper, layout: int, table, fields, tps, windows, window,
                palette=None, chunk: int = _SUM_CHUNK,
                ctas: Optional[int] = None):
    """(loss_sum, valid_count) of one plan group: the group-sum kernel for
    CUDA tensors (counted on ``wrapper``), the plain version for CPU ones.
    ``palette`` re-bakes the targets: ``pack_rgb24`` of the colours for
    compact and q8 plans, the (N, 3) or (N, 4) colours for f32 plans.
    ``chunk`` is the number of consecutive plan blocks a CTA takes at a time
    and ``ctas`` caps the grid (default: the CTAs the card holds at once)."""
    name = wrapper.__name__
    if layout == _Q8 and window > _Q8_MAX_WINDOW:
        raise ValueError(f"q8 plans need window <= {_Q8_MAX_WINDOW}")
    if palette is not None:
        if layout == _F32 and (palette.dim() != 2
                               or palette.shape[1] not in (3, 4)):
            raise ValueError(f"{name}: rgb must be (N, 3) or (N, 4)")
        if layout != _F32 and palette.dim() != 1:
            raise ValueError(f"{name}: palette must be (N,)")
    nf, field_dtype = {_COMPACT: (3, torch.float32), _Q8: (1, torch.int32),
                       _F32: (8, torch.float32)}[layout]
    if not _check(table, fields, tps, windows, window, nf, field_dtype, name,
                  palette):
        if layout == _F32:
            return slab_group_sums_f32_plain(table, fields, windows, window,
                                             palette)
        plain = slab_group_sums_q8_plain if layout == _Q8 else \
            slab_group_sums_compact_plain
        return plain(table, fields, tps, windows, window, palette)
    nb, _, block = fields.shape
    if block % 4:
        raise ValueError(f"{name}: block must be a multiple of 4 (the kernel "
                         f"reads four samples at a time), got {block}")
    if not 1 <= chunk <= 32:
        raise ValueError(f"{name}: chunk must be in [1, 32], got {chunk}")
    if layout == _F32 and palette is not None and palette.shape[1] == 3:
        palette = _rgb4(palette)
    tensors = [t for t in (table, fields, tps, palette) if t is not None]
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: table, fields, tps and palette must be "
                         "16-byte aligned")
    if nb == 0:
        zeros = torch.zeros(GROUP, dtype=torch.float32, device=fields.device)
        return zeros, zeros.clone()
    if ctas is None:
        ctas = _max_ctas(fields.device.index, layout, palette is not None,
                         window)
    n_cta = max(1, min(-(-nb // chunk), ctas))
    partials = torch.empty((n_cta, 2, GROUP), dtype=torch.float32,
                           device=fields.device)
    with on_device(fields.device) as stream:
        err = _sums_launcher()(
            layout, table.data_ptr(), fields.data_ptr(),
            None if tps is None else tps.data_ptr(),
            None if palette is None else palette.data_ptr(),
            0 if palette is None else palette.shape[0], windows.data_ptr(),
            partials.data_ptr(), n_cta, nb, block, window, chunk, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    count_launch(wrapper, fields.device)
    sums = partials.sum(0)
    return sums[0], sums[1]


def slab_group_sums_f32(table: torch.Tensor, fields: torch.Tensor,
                        windows: torch.Tensor, window: int,
                        rgb: Optional[torch.Tensor] = None):
    """Kernel wrapper of :func:`slab_group_sums_f32_plain`: one launch
    scores the whole group and, with ``rgb``, takes each sample's target
    from ``rgb[pid]`` itself, so the plan is not copied.  ``rgb`` may be
    the zero-padded (N, 4) copy of the colours, which saves making it on
    every call.  The point ids must index ``rgb``: the kernel traps on one
    that does not, as an out-of-range gather does."""
    return _group_sums(slab_group_sums_f32, _F32, table, fields, None,
                       windows, window, rgb)


def slab_group_sums_compact(table: torch.Tensor, fields: torch.Tensor,
                            tps: torch.Tensor, windows: torch.Tensor,
                            window: int,
                            palette: Optional[torch.Tensor] = None):
    """Kernel wrapper of :func:`slab_group_sums_compact_plain`: one launch
    scores the whole group and, with ``palette``, re-bakes its targets from
    the point ids in ``tps``.  The point ids must index ``palette``: the
    kernel traps on one that does not, as an out-of-range gather does."""
    return _group_sums(slab_group_sums_compact, _COMPACT, table, fields, tps,
                       windows, window, palette)


def slab_group_sums_q8(table: torch.Tensor, fields: torch.Tensor,
                       tps: torch.Tensor, windows: torch.Tensor, window: int,
                       palette: Optional[torch.Tensor] = None):
    """Kernel wrapper of :func:`slab_group_sums_q8_plain`."""
    return _group_sums(slab_group_sums_q8, _Q8, table, fields, tps, windows,
                       window, palette)


for _w in (slab_group_sums_f32, slab_group_sums_compact, slab_group_sums_q8):
    _w.launches, _w.by_card = 0, {}


def _check_refresh(compact: bool, tp_is_pid: bool, rgb) -> None:
    if compact and tp_is_pid and rgb is None:
        raise ValueError(
            "compact plan was built refresh-capable (tp_is_pid=True); "
            "pass the cloud colors so targets can be baked"
        )
    if compact and rgb is not None and not tp_is_pid:
        raise ValueError(
            "per-query color refresh needs a compact plan built with "
            "tp_is_pid=True (this one stores packed targets, not point ids)"
        )


def slab_group_partials(table: torch.Tensor, fields: torch.Tensor,
                        windows: torch.Tensor, window: int = WINDOW,
                        rgb: Optional[torch.Tensor] = None,
                        tps: Optional[torch.Tensor] = None,
                        compact: bool = False, quant: bool = False):
    """(loss_sum, valid_count), each (128,), of ONE candidate group.

    ``rgb`` re-bakes the targets from the plan's point ids (per-query
    colour rebinds).  The group keeps its streams: the kernel looks each
    target up in ``rgb`` (f32 plans) or in the packed palette
    ``pack_rgb24(rgb)`` (compact and q8 plans)."""
    if compact or quant:
        sums = slab_group_sums_q8 if quant else slab_group_sums_compact
        return sums(table, fields, tps, windows, window,
                    None if rgb is None else pack_rgb24(rgb))
    return slab_group_sums_f32(table, fields, windows, window, rgb)


def plan_group_sums(table: torch.Tensor, plan: GridPlan,
                    rgb: Optional[torch.Tensor] = None):
    """(loss_sum, valid_count) of every group of ``plan`` against the
    kernel's ``table`` (:func:`slab_table`), one launch a group; ``rgb``
    re-bakes the targets (its palette is made once for all groups)."""
    _check_refresh(plan.compact, plan.tp_is_pid, rgb)
    if plan.compact:
        sums = slab_group_sums_q8 if plan.quant else slab_group_sums_compact
        palette = None if rgb is None else pack_rgb24(rgb)  # once a query
        return [sums(table, f, tps, w, plan.window, palette)
                for f, w, tps in zip(plan.fields, plan.windows, plan.tps)]
    rgb4 = None if rgb is None else _rgb4(rgb)  # once a query
    return [slab_group_sums_f32(table, f, w, plan.window, rgb4)
            for f, w in zip(plan.fields, plan.windows)]


def _check_plan_image(plan, H: int, W: int) -> None:
    if plan.height and (plan.height, plan.width) != (H, W):
        raise ValueError(
            f"plan was built for a {plan.height}x{plan.width} init image but "
            f"the query image is {H}x{W} — its table rows index a different "
            "sampling table (stale plan?)"
        )


def slab_pair_scores(img: torch.Tensor, plan: GridPlan,
                     rgb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stage-1 sampling losses of the planned pairs, (n_pairs,) f32, +inf
    where a pair samples nothing.  Pass ``rgb`` when the cloud colours
    differ from the ones the plan was built with."""
    H, W, _ = img.shape
    _check_plan_image(plan, H, W)
    table = slab_table(img, wrap=plan.wrap, window=plan.window)
    scores = []
    for tot, cnt in plan_group_sums(table, plan, rgb):
        mean = tot / cnt.clamp_min(1.0)
        scores.append(torch.where(cnt > 0, mean,
                                  torch.full_like(mean, float("inf"))))
    return torch.cat(scores)[: plan.n_pairs]
