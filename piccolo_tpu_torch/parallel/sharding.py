"""One query's descent over a ('cand', 'point') mesh of devices (port of
piccolo_tpu.parallel.sharding).

Two axes, as in the JAX package:

  * ``cand``: the starts split into contiguous groups, one a mesh row;
  * ``point``: the cloud splits into contiguous slices, one a mesh column.
    The loss is a mean over points, so each shard's sums (colour distance
    total, valid count) added over the row give the whole cloud's loss.

The JAX package runs this as one SPMD program with ``psum`` collectives.
Here one process drives every device of the mesh from one host thread, and
each collective is an explicit operation: a shard's sums are copied to its
row's lead device (the row's first shard's) and added there in shard
order, so a run is deterministic.  The descent's step is split in two
(``solver.mesh_run``): each shard's loss sums and their pose gradient, and
the lead's combine, Adam, plateau and clamp; on the card each half is a
captured graph.

The mesh may repeat a device: every shard of a CPU mesh is ``cpu`` (the
counterpart of the JAX tests' virtual devices), and a one-card mesh puts
every shard on ``cuda:0``.

Across hosts, :func:`init_distributed` joins one process a host into a
``torch.distributed`` process group; a sweep then splits its queries over
the processes (``query_shards`` / ``query_shard_index``), which needs no
collective, and each process's mesh spans its own host's cards.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import as_tensor
from ..loss import Pose, pose_rotation
from ..ops.sampling import (
    cast_packed_table,
    pack_bilinear_blocks,
    resolve_descent_table,
)
from ..optim import AdamPlateauState, init_adam_plateau
from ..solver import (
    MeshGroup,
    ShardInputs,
    SolveResult,
    StepStatics,
    _check_prune,
    _take,
    mesh_run,
)

__all__ = ["Mesh", "make_mesh", "ShardedCloud", "shard_cloud",
           "solve_sharded", "descent_local", "init_distributed"]


# Environment variables whose presence means "this process was launched as
# part of a cluster" (torchrun, SLURM, or the JAX package's launchers): an
# auto-detection that fails under any of them is a misconfiguration, not a
# plain single-process run
_CLUSTER_ENV_VARS = (
    "MASTER_ADDR",
    "WORLD_SIZE",
    "TORCHELASTIC_RUN_ID",
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "SLURM_STEP_NODELIST",
)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     strict: bool = False, device="cuda") -> int:
    """Join this process into a multi-host ``torch.distributed`` process
    group (one process a host); the counterpart of the JAX package's
    ``jax.distributed.initialize`` wrapper.  The backend is ``nccl`` for
    the card and ``gloo`` for ``device="cpu"``.  Call once per process
    before a sweep; then ``query_shards=torch.distributed.get_world_size(),
    query_shard_index=`` the returned index split its queries.

    Three argument paths, as in the JAX package:
      * explicit: ``coordinator_address`` (``host:port`` of process 0, or a
        ``tcp://`` URL) with ``num_processes`` and ``process_id``:
        initialization errors propagate (torch cannot infer a missing count
        or index over ``tcp://``, and says so);
      * ``num_processes=1`` (no coordinator): a single-process no-op;
      * none: auto-detect from the environment (``env://``: ``MASTER_ADDR``,
        ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as torchrun sets them).
        If that FAILS while cluster launch variables are present, the
        process would silently run one N-th of a sharded sweep, so it warns
        loudly (or, with ``strict=True``, raises).

    Returns the process index (0 without a process group).
    """
    import torch.distributed as dist

    if process_id is not None and coordinator_address is None:
        raise ValueError(
            "process_id without coordinator_address is meaningless: pass "
            "both with num_processes, num_processes=1 alone, or nothing "
            "(auto-detect)")
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(
            backend, init_method=url,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
    elif num_processes is None:
        try:
            dist.init_process_group(backend, init_method="env://")
        except Exception as exc:
            present = [v for v in _CLUSTER_ENV_VARS if os.environ.get(v)]
            if present:
                if strict:
                    raise
                msg = (
                    "torch.distributed auto-detection FAILED "
                    f"({type(exc).__name__}: {exc}) although cluster launch "
                    f"environment variables are set ({', '.join(present)}). "
                    "Continuing SINGLE-PROCESS: a sharded sweep on this "
                    "config would silently run 1/Nth of its queries per "
                    "host. Pass explicit coordinator_address/num_processes/"
                    "process_id, or strict=True to raise.")
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
                print(f"WARNING: {msg}", file=sys.stderr, flush=True)
            # else: a plain single-process environment, nothing to join
    elif num_processes != 1:
        raise ValueError(
            f"num_processes={num_processes} needs coordinator_address and "
            "process_id (explicit cluster path)")
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """An (n_cand, n_point) grid of torch devices with axes ``cand`` and
    ``point``; a device may appear more than once."""

    def __init__(self, devices):
        rows = [list(row) for row in devices]
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for c, row in enumerate(rows):
            for p, d in enumerate(row):
                self.devices[c, p] = _device(d)

    @property
    def shape(self) -> dict:
        return {"cand": self.devices.shape[0], "point": self.devices.shape[1]}

    @property
    def lead(self) -> torch.device:
        """The device the query's selections and results live on."""
        return self.devices[0, 0]

    def fingerprint(self) -> Tuple[str, ...]:
        """The devices in order: two meshes of one shape over different
        devices never share device-resident state."""
        return tuple(str(d) for d in self.devices.flat)

    def cards(self) -> List[torch.device]:
        """The distinct devices, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        c, p = self.devices.shape
        return f"Mesh({c}x{p}: {', '.join(self.fingerprint())})"


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_cand: Optional[int] = None, n_point: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('cand', 'point') mesh over ``devices`` (default: every visible
    card).  The default factorization favours the point axis, as the JAX
    package's does: at most 2-way ``cand`` (when there are at least 4
    devices and their count is even), the rest on ``point``."""
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cards == 0:
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * n for "
                "a mesh of n logical shards on the CPU")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if n_cand is None and n_point is None:
        n_cand = 2 if (n >= 4 and n % 2 == 0) else 1
        n_point = n // n_cand
    elif n_point is None:
        n_point = n // n_cand
    elif n_cand is None:
        n_cand = n // n_point
    assert n_cand * n_point == n, (n_cand, n_point, n)
    return Mesh([devices[c * n_point:(c + 1) * n_point]
                 for c in range(n_cand)])


@dataclasses.dataclass
class ShardedCloud:
    """A cloud laid out on a mesh: ``xyz[c][p]``, ``rgb[c][p]`` and
    ``mask[c][p]`` hold point slice p on device (c, p).  ``rows`` is the
    padded row count (a multiple of the point axis; padding is masked
    out)."""

    xyz: List[List[torch.Tensor]]
    rgb: List[List[torch.Tensor]]
    mask: List[List[torch.Tensor]]
    rows: int
    mesh_key: Tuple[str, ...]

    def with_rgb(self, mesh: Mesh, rgb) -> "ShardedCloud":
        """The same points with other colours (a per-query rebind)."""
        return dataclasses.replace(
            self, rgb=_place(mesh, _pad_rows(_rows_tensor(rgb), self.rows)))


def _rows_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach()
    return torch.as_tensor(np.asarray(a))


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``a`` padded with zero rows (False for a mask) to ``rows``."""
    pad = rows - a.shape[0]
    if pad:
        a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    return a


def _place(mesh: Mesh, a: torch.Tensor) -> List[List[torch.Tensor]]:
    """Contiguous slice p of ``a`` on device (c, p) for every c; no copy
    where a slice is already there."""
    per = a.shape[0] // mesh.shape["point"]
    return [[a[p * per:(p + 1) * per].to(dev).contiguous()
             for p, dev in enumerate(row)] for row in mesh.devices]


def shard_cloud(mesh: Mesh, xyz, rgb, point_mask=None) -> ShardedCloud:
    """Pad the cloud to the point axis (zero points, masked out) and lay it
    out on the mesh once; pass the result to :func:`localize_query_sharded`
    or :func:`solve_sharded` in place of the raw cloud."""
    xyz = _rows_tensor(xyz).to(torch.float32)
    n = xyz.shape[0]
    mask = (torch.ones(n, dtype=torch.bool, device=xyz.device)
            if point_mask is None else _rows_tensor(point_mask).to(torch.bool))
    rows = n + (-n) % mesh.shape["point"]
    return ShardedCloud(
        xyz=_place(mesh, _pad_rows(xyz, rows)),
        rgb=_place(mesh, _pad_rows(_rows_tensor(rgb).to(torch.float32), rows)),
        mask=_place(mesh, _pad_rows(mask, rows)), rows=rows,
        mesh_key=mesh.fingerprint())


def _to(tree, dev):
    """A Pose or optimizer state on ``dev``."""
    if isinstance(tree, Pose):
        return Pose(*[x.to(dev) for x in tree.leaves()])
    return AdamPlateauState(
        m=_to(tree.m, dev), v=_to(tree.v, dev), count=tree.count.to(dev),
        lr=tree.lr.to(dev), best=tree.best.to(dev),
        num_bad=tree.num_bad.to(dev))


def _cat(trees, dev):
    """Row-concatenation of Poses or optimizer states, on ``dev``."""
    if isinstance(trees[0], Pose):
        return Pose(*[torch.cat([x.to(dev) for x in xs])
                      for xs in zip(*(t.leaves() for t in trees))])
    return AdamPlateauState(
        m=_cat([t.m for t in trees], dev), v=_cat([t.v for t in trees], dev),
        **{k: torch.cat([getattr(t, k).to(dev) for t in trees])
           for k in ("count", "lr", "best", "num_bad")})


def _where_rows(found, a, b):
    """Rows of Pose ``a`` where ``found``, else of ``b``."""
    def pick(x, y):
        return torch.where(found.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
    return Pose(*[pick(x, y) for x, y in zip(a.leaves(), b.leaves())])


def _mesh_groups(mesh: Mesh, cloud: ShardedCloud, img: torch.Tensor,
                 lo, hi, table_dtype: str, wrap: bool) -> List[MeshGroup]:
    """Every cand group's shards: the packed table of ``img`` (built once a
    device) and the group's cloud slices, and the clamp box on its lead."""
    tables = {}
    for dev in mesh.cards():
        tables[dev] = cast_packed_table(
            pack_bilinear_blocks(img.to(dev), wrap=wrap), table_dtype)
    groups = []
    for c, row in enumerate(mesh.devices):
        shards = tuple(
            ShardInputs(tables[dev], cloud.xyz[c][p], cloud.rgb[c][p],
                        cloud.mask[c][p]) for p, dev in enumerate(row))
        groups.append(MeshGroup(shards, lo.to(row[0]), hi.to(row[0])))
    return groups


def descent_local(mesh: Mesh, cloud: ShardedCloud, img, t0, ypr0, lo, hi,
                  valid=None, *, num_iter: int, lr: float, patience: int,
                  factor: float, table_dtype: str = "auto",
                  wrap: bool = False, prune=None,
                  n_valid: Optional[int] = None, _eager: bool = False):
    """The multi-start descent over the mesh: (S, 3) starts, S a multiple
    of the cand axis, split contiguously over the cand groups; every loss
    and gradient is the whole cloud's, combined over the group's point
    shards.  Returns (t, ypr, losses, lrs) on the mesh's lead device, rows
    in input order.

    ``prune=(k, m)``: after k iterations every group's losses and states
    are gathered on the lead; the m best starts (clone rows at or beyond
    ``n_valid`` and rows whose ``valid`` is False rank last) are spread
    evenly over the groups (slots padded with the best), finish the budget
    there, and come back into their rows; pruned rows keep their phase-1
    state, as on one device."""
    n_cand = mesh.shape["cand"]
    lead = mesh.lead
    H, W, _ = img.shape
    groups = _mesh_groups(mesh, cloud, img, lo, hi,
                          resolve_descent_table(table_dtype, H, W,
                                                img.device), wrap)
    s = StepStatics(H, W, int(patience), float(factor), bool(wrap))
    b_l = t0.shape[0] // n_cand

    def start(c, t, y):
        dev = mesh.devices[c, 0]
        params = Pose(t=t.to(dev), yaw=y[:, 0].to(dev),
                      pitch=y[:, 1].to(dev), roll=y[:, 2].to(dev))
        return params, init_adam_plateau(params, lr)

    starts = [start(c, t0[c * b_l:(c + 1) * b_l], ypr0[c * b_l:(c + 1) * b_l])
              for c in range(n_cand)]
    if prune is None:
        out = mesh_run(groups, s, [p for p, _ in starts],
                       [st for _, st in starts], num_iter, eager=_eager)
        params = _cat([p for p, _, _ in out], lead)
        losses = torch.cat([loss.to(lead) for _, _, loss in out])
        lrs = torch.cat([st.lr.to(lead) for _, st, _ in out])
        return params.t, params.ypr(), losses, lrs

    k_it, m = prune
    out1 = mesh_run(groups, s, [p for p, _ in starts],
                    [st for _, st in starts], k_it, eager=_eager)
    params1 = _cat([p for p, _, _ in out1], lead)
    state1 = _cat([st for _, st, _ in out1], lead)
    loss1 = torch.cat([loss.to(lead) for _, _, loss in out1])
    gids = torch.arange(loss1.shape[0], device=lead)
    inf = torch.full_like(loss1, math.inf)
    rank = loss1
    if n_valid is not None:
        rank = torch.where(gids < n_valid, rank, inf)
    if valid is not None:
        rank = torch.where(valid.to(lead), rank, inf)
    order = torch.argsort(rank, stable=True)
    per = -(-m // n_cand)  # survivors a group; spare slots repeat the best
    surv = torch.cat([order[:m], order[:1].expand(per * n_cand - m)])
    slots = [surv[c * per:(c + 1) * per] for c in range(n_cand)]
    dev_of = [mesh.devices[c, 0] for c in range(n_cand)]
    out2 = mesh_run(
        groups, s,
        [_to(_take(params1, sl), d) for sl, d in zip(slots, dev_of)],
        [_to(_take(state1, sl), d) for sl, d in zip(slots, dev_of)],
        num_iter - k_it, eager=_eager)
    fin_p = _cat([p for p, _, _ in out2], lead)
    fin_l = torch.cat([loss.to(lead) for _, _, loss in out2])
    fin_lr = torch.cat([st.lr.to(lead) for _, st, _ in out2])
    # each row's survivor slot, if it has one (the first, for the best)
    hit = surv[None, :] == gids[:, None]
    found = hit.any(1)
    pos = hit.to(torch.int32).argmax(1)
    params = _where_rows(found, _take(fin_p, pos), params1)
    losses = torch.where(found, fin_l[pos], loss1)
    lrs = torch.where(found, fin_lr[pos], state1.lr)
    return params.t, params.ypr(), losses, lrs


def _pad_axis0(a: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """``a`` padded to a multiple of ``multiple`` rows with copies of its
    first row, and its original row count."""
    n = a.shape[0]
    pad = (-n) % multiple
    if pad:
        a = np.concatenate([a, np.broadcast_to(a[:1], (pad,) + a.shape[1:])])
    return a, n


def solve_sharded(mesh: Mesh, img, xyz, rgb, trans0, ypr0, lo, hi,
                  point_mask=None, *, num_iter: int = 100, lr: float = 0.1,
                  patience: int = 5, factor: float = 0.9,
                  table_dtype: str = "auto", wrap: bool = False, prune=None):
    """Multi-start descent over the mesh; the contract of
    ``solver.solve``.  Starts are padded to the cand axis with clones of
    the first and the cloud to the point axis with masked-out points;
    neither changes a result.  ``xyz`` may be a :class:`ShardedCloud`
    (``rgb`` and ``point_mask`` are then ignored).  Returns (t, R, loss,
    SolveResult over the given starts), on the mesh's lead device."""
    n_cand = mesh.shape["cand"]
    lead = mesh.lead
    cloud = xyz if isinstance(xyz, ShardedCloud) else shard_cloud(
        mesh, xyz, rgb, point_mask)
    trans0, b = _pad_axis0(np.asarray(trans0, np.float32), n_cand)
    ypr0, _ = _pad_axis0(np.asarray(ypr0, np.float32), n_cand)
    prune = _check_prune(prune, num_iter, b, False)
    t, ypr, losses, lrs = descent_local(
        mesh, cloud, as_tensor(img, lead, torch.float32),
        torch.as_tensor(trans0, device=lead),
        torch.as_tensor(ypr0, device=lead),
        as_tensor(lo, lead, torch.float32), as_tensor(hi, lead, torch.float32),
        num_iter=num_iter, lr=lr, patience=patience, factor=factor,
        table_dtype=table_dtype, wrap=wrap, prune=prune,
        n_valid=b if prune is not None else None)
    t, ypr, losses, lrs = t[:b], ypr[:b], losses[:b], lrs[:b]
    rot = pose_rotation(Pose(t=t, yaw=ypr[:, 0], pitch=ypr[:, 1],
                             roll=ypr[:, 2]))
    res = SolveResult(t=t, ypr=ypr, rot=rot, loss=losses, lr=lrs)
    k = torch.argmin(losses)
    return t[k], rot[k], losses[k], res
