"""Stage-1 candidate-grid scoring from room-static sorted sample streams.

Port of piccolo_tpu/kernels/slab_sampling.py, f32 plan layout.  Stage-1
sample locations depend only on the room (cloud + candidate grid), so the
plan computes every (pair, point) -> (table row, bilinear fractions) once,
sorts each 128-pair group's samples by table row and pads them into blocks
that each lie inside one aligned table window.  Per query, the CUDA kernel
``csrc/slab_sampling.cu`` scores every block against its window of the
packed sampling table; :func:`slab_block_partials_plain` is the same
function in plain PyTorch.

The plan keeps the JAX package's stream layout, (NB, 8, BLOCK) f32 fields
[lidx, wx1, wy1, r, g, b, cid, pid] per group plus (NB,) int32 windows, so
plans compare field for field and a JAX-built plan runs here unchanged
(``convert.grid_plan_from_numpy``).  The compact and q8 layouts belong to a
later slice of the port.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..device import as_tensor, resolve_device
from ..loss import Pose, transform_cloud
from ..ops.projection import safe_norm, spherical_project
from ..ops.sampling import pack_bilinear_blocks, packed_rows_and_weights
from ._build import load_library, stream_ptr

__all__ = [
    "GridPlan",
    "PlanOverBudget",
    "make_pairs",
    "build_grid_plan",
    "slab_table",
    "slab_block_partials",
    "slab_block_partials_plain",
    "slab_group_partials",
    "slab_pair_scores",
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

# field order in the packed (8, BLOCK) sample block
_F_LIDX, _F_WX1, _F_WY1, _F_TR, _F_TG, _F_TB, _F_CID, _F_PID = range(8)

_UNPORTED = ("compact and q8 slab plans are not ported yet: they come with "
             "the plan admission ladder in a later slice of the port")


def resolve_plan_geometry(n_points: int, height: int, width: int,
                          window=None, block=None):
    """(window, block) for a plan: (128, 1024) for dense tables (>= 0.25
    points per table row), else (256, 512); explicit values override.  The
    rule is the JAX package's, carried over unchanged."""
    if window is None and block is None:
        density = n_points / float(_table_rows(height, width))
        return (128, 1024) if density >= 0.25 else (256, 512)
    return (int(window or WINDOW), int(block or BLOCK))


DEFAULT_PLAN_BYTES_CAP = 9 * 10**9
_PLAN_MEM_FRACTION = 9.0 / 16.0


def default_plan_bytes_cap(device=None) -> int:
    """9/16 of the card's memory for a plan's streams (the JAX package's
    fraction, not yet re-decided for the H100); the fixed default off the
    card."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
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


def plan_exact_bytes(n_groups: int, nb: int, block: int = BLOCK) -> int:
    """Exact footprint of an f32 plan: 32 B a sample slot plus the windows."""
    return n_groups * (nb * block * 32 + nb * 4)


@dataclasses.dataclass
class GridPlan:
    """Room-static sorted sample streams for :func:`slab_pair_scores`.

    fields:  per-group (NB, 8, BLOCK) f32 sample blocks; padding slots
             carry lidx = cid = -1 and contribute nothing.
    windows: per-group (NB,) int32 aligned table-window index per block.
    n_pairs: leading candidate pairs the plan covers (pairs beyond it are
             the consumer's to mask).
    height/width: the init-image shape the table rows were computed for.
    """

    fields: Tuple[torch.Tensor, ...]
    windows: Tuple[torch.Tensor, ...]
    n_pairs: int
    height: int
    width: int
    wrap: bool = False
    window: int = WINDOW
    block: int = BLOCK

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.fields + self.windows)


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


def _nb_bucket(n: int) -> int:
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


def _layout_group(row, wx1, wy1, rgb, *, nb: int, n_win: int, window: int,
                  block: int):
    """Sorted, window-padded sample blocks of one group from its projected
    (G, N) rows and fractions: the layout half of the JAX package's
    ``_plan_group``.  Returns ((nb, 8, block) f32 fields, (nb,) int32
    windows)."""
    G, N = row.shape
    dev = row.device
    cid = torch.arange(G, dtype=torch.float32, device=dev)[:, None].expand(G, N)
    pid = torch.arange(N, dtype=torch.float32, device=dev)[None].expand(G, N)
    tgt = rgb.T[:, None, :].expand(3, G, N)

    # stable sort by row, payloads follow the permutation (jax.lax.sort)
    row_s, perm = torch.sort(row.reshape(-1).to(torch.int64), stable=True)
    vals = [x.reshape(-1)[perm]
            for x in (wx1, wy1, tgt[0], tgt[1], tgt[2], cid, pid)]

    win = row_s // window
    edges = torch.arange(n_win + 1, dtype=torch.int64, device=dev) * window
    starts = torch.searchsorted(row_s, edges, side="left")
    blocks_w = (torch.diff(starts) + block - 1) // block
    block_off = torch.cumsum(blocks_w, 0) - blocks_w
    i = torch.arange(row_s.shape[0], dtype=torch.int64, device=dev)
    positions = i - starts[win] + block_off[win] * block
    lidx = (row_s - win * window).to(torch.float32)

    payload = torch.stack([lidx] + vals, dim=-1)  # (M, 8)
    # pads: lidx = cid = -1 select no table row and no pair
    empty = torch.tensor([-1, 0, 0, 0, 0, 0, -1, 0], dtype=torch.float32,
                         device=dev)
    flat = empty.expand(nb * block, 8).clone()
    flat.index_put_((positions,), payload)
    fields = flat.reshape(nb, block, 8).transpose(1, 2).contiguous()
    windows = torch.zeros(nb, dtype=torch.int32, device=dev)
    windows.scatter_reduce_(0, positions // block, win.to(torch.int32), "amax",
                            include_self=True)
    return fields, windows


def _padded_pairs(trans_grid, rot_grid):
    pair_t, pair_r = make_pairs(trans_grid, rot_grid)
    P = pair_t.shape[0]
    pad = (-P) % GROUP
    if pad:
        pair_t = torch.cat([pair_t, pair_t[:1].expand(pad, 3)])
        pair_r = torch.cat([pair_r, pair_r[:1].expand(pad, 3)])
    return pair_t, pair_r, P


def build_grid_plan(xyz, rgb, point_mask, trans_grid, rot_grid, height: int,
                    width: int, compact: bool = False, quant: bool = False,
                    bytes_cap: Optional[int] = None, wrap: bool = False,
                    window: Optional[int] = None, block: Optional[int] = None,
                    device="cuda") -> GridPlan:
    """Build the room-static sorted sample streams (once per room and
    init-image size).

    ``trans_grid`` should hold only the real (unpadded) rows.  A sizing
    pass fixes the bucketed block count; ``bytes_cap`` then raises
    :class:`PlanOverBudget` before any stream is built.  Groups are built
    one after another, so peak memory stays about one group above the plan.
    """
    if compact or quant:
        raise NotImplementedError(_UNPORTED)
    dev = resolve_device(device)
    xyz = as_tensor(xyz, dev, torch.float32)
    rgb = as_tensor(rgb, dev, torch.float32)
    pm = None if point_mask is None else as_tensor(point_mask, dev, torch.bool)
    pair_t, pair_r, P = _padded_pairs(as_tensor(trans_grid, dev, torch.float32),
                                      as_tensor(rot_grid, dev, torch.float32))
    n_groups = pair_t.shape[0] // GROUP
    window, block = resolve_plan_geometry(xyz.shape[0], height, width,
                                          window, block)
    n_win = _rpad(height, width, window) // window

    def project(g):
        sl = slice(g * GROUP, (g + 1) * GROUP)
        return _project_group(xyz, pm, pair_t[sl], pair_r[sl], height, width,
                              wrap)

    nb = _nb_bucket(max(_blocks_needed(project(g)[0], n_win, window, block)
                        for g in range(n_groups)))
    if bytes_cap is not None:
        exact = plan_exact_bytes(n_groups, nb, block)
        if exact > bytes_cap:
            raise PlanOverBudget(exact, bytes_cap)
    fields, windows = [], []
    for g in range(n_groups):
        f, w = _layout_group(*project(g), rgb, nb=nb, n_win=n_win,
                             window=window, block=block)
        fields.append(f)
        windows.append(w)
    return GridPlan(fields=tuple(fields), windows=tuple(windows), n_pairs=P,
                    height=height, width=width, wrap=wrap, window=window,
                    block=block)


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


def slab_block_partials_plain(table: torch.Tensor, fields: torch.Tensor,
                              windows: torch.Tensor,
                              window: int) -> torch.Tensor:
    """(NB, 2, 128) per-block loss sums and valid counts per pair id."""
    nb, _, block = fields.shape
    li = fields[:, _F_LIDX].to(torch.int64)
    cid = fields[:, _F_CID].to(torch.int64)
    ok = (li >= 0) & (cid >= 0)
    rows = windows.to(torch.int64)[:, None] * window + li.clamp_min(0)
    v = table[rows]  # (NB, block, 12)
    x1 = fields[:, _F_WX1, :, None]
    y1 = fields[:, _F_WY1, :, None]
    x0 = 1.0 - x1
    y0 = 1.0 - y1
    # same tap/term order as ops.sampling.bilinear_sample_packed
    s = (v[..., 0:3] * (x0 * y0) + v[..., 3:6] * (x1 * y0)
         + v[..., 6:9] * (x0 * y1) + v[..., 9:12] * (x1 * y1))
    valid = ((s == 0.0).sum(-1) != 3) & ok
    per = safe_norm(s - fields[:, _F_TR:_F_TB + 1].transpose(1, 2))
    out = torch.zeros((nb, 2, GROUP), dtype=torch.float32,
                      device=fields.device)
    c = cid.clamp_min(0)
    out[:, 0].scatter_add_(1, c, per * valid)
    out[:, 1].scatter_add_(1, c, valid.to(torch.float32))
    return out


@functools.cache
def _launcher():
    fn = load_library("slab_sampling").slab_partials_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_MAX_WINDOW = 1000  # window x 12 f32 + the accumulators within 48 KB smem


def slab_block_partials(table: torch.Tensor, fields: torch.Tensor,
                        windows: torch.Tensor, window: int) -> torch.Tensor:
    """Kernel wrapper of :func:`slab_block_partials_plain`."""
    if table.dim() != 2 or table.shape[1] != 12 or table.shape[0] % window:
        raise ValueError(f"table must be (rp, 12) with rp a multiple of "
                         f"{window}, got {tuple(table.shape)}")
    if fields.dim() != 3 or fields.shape[1] != 8:
        raise ValueError(f"fields must be (NB, 8, block), got "
                         f"{tuple(fields.shape)}")
    if windows.shape != (fields.shape[0],):
        raise ValueError("windows must be (NB,)")
    if (table.dtype, fields.dtype, windows.dtype) != (
            torch.float32, torch.float32, torch.int32):
        raise TypeError("need f32 table and fields and int32 windows")
    if not table.device == fields.device == windows.device:
        raise ValueError("table, fields and windows must be on one device")
    if fields.device.type == "cpu":
        return slab_block_partials_plain(table, fields, windows, window)
    if fields.device.type != "cuda":
        raise ValueError(f"unsupported device {fields.device}")
    if not all(t.is_contiguous() for t in (table, fields, windows)):
        raise ValueError("table, fields and windows must be contiguous")
    if not 0 < window <= _MAX_WINDOW:
        raise ValueError(f"window must be in (0, {_MAX_WINDOW}]")
    nb, _, block = fields.shape
    out = torch.empty((nb, 2, GROUP), dtype=torch.float32,
                      device=fields.device)
    if nb == 0:
        return out
    err = _launcher()(table.data_ptr(), fields.data_ptr(), windows.data_ptr(),
                      out.data_ptr(), nb, block, window,
                      stream_ptr(fields.device))
    if err != 0:
        raise RuntimeError(f"slab_block_partials launch failed: CUDA error {err}")
    slab_block_partials.launches += 1
    return out


slab_block_partials.launches = 0


def slab_group_partials(table: torch.Tensor, fields: torch.Tensor,
                        windows: torch.Tensor, window: int = WINDOW,
                        rgb: Optional[torch.Tensor] = None):
    """(loss_sum, valid_count), each (128,), of ONE candidate group.

    ``rgb`` re-bakes the targets from the plan's point ids (per-query
    colour rebinds): the group's fields are copied with new rgb rows."""
    if rgb is not None:
        pids = fields[:, _F_PID].to(torch.int64)
        fields = fields.clone()
        fields[:, _F_TR:_F_TB + 1] = rgb[pids].permute(0, 2, 1)
    out = slab_block_partials(table, fields, windows, window)
    return out[:, 0].sum(0), out[:, 1].sum(0)


def slab_pair_scores(img: torch.Tensor, plan: GridPlan,
                     rgb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stage-1 sampling losses of the planned pairs, (n_pairs,) f32, +inf
    where a pair samples nothing.  Pass ``rgb`` when the cloud colours
    differ from the ones the plan was built with."""
    H, W, _ = img.shape
    if plan.height and (plan.height, plan.width) != (H, W):
        raise ValueError(
            f"plan was built for a {plan.height}x{plan.width} init image but "
            f"the query image is {H}x{W} — its table rows index a different "
            "sampling table (stale plan?)"
        )
    table = slab_table(img, wrap=plan.wrap, window=plan.window)
    scores = []
    for fields, windows in zip(plan.fields, plan.windows):
        tot, cnt = slab_group_partials(table, fields, windows, plan.window,
                                       rgb)
        mean = tot / cnt.clamp_min(1.0)
        scores.append(torch.where(cnt > 0, mean,
                                  torch.full_like(mean, float("inf"))))
    return torch.cat(scores)[: plan.n_pairs]
