"""Multi-start gradient-descent pose solver (port of piccolo_tpu.solver).

All starts advance together: the pose leaves carry a leading start
dimension where the JAX package uses ``vmap``.  Each start's loss depends
only on its own pose, so one ``autograd.grad`` of the summed losses gives
every start its own gradient.  The translation clamp applies to the
parameters only, after each Adam update (Adam moments are not projected).

On the card the descent is one captured device program, the counterpart of
the JAX package's ``lax.scan`` under ``jit``: the step is captured once per
shape key as a CUDA graph that reads and writes static buffers in place,
and a descent copies its inputs in, replays the graph once per iteration
and returns clones of the buffers.  On one cloud the step the graph holds
is the two hand-written kernels of ``kernels/descent_step.py`` (loss,
count and analytic pose gradient, then Adam + plateau + clamp in place;
``descent_step.engages`` chooses them from the inputs); an (R, N, 3) stack
of rooms captures the autograd step (forward, ``autograd.grad``, Adam +
plateau, clamp).  A ``_run`` counts its steps as ``descent.steps_kernel``
or ``descent.steps_plain`` (``utils.profiling.count``).  The key is the
device, the statics (table height and width, patience, factor, wrap) and
the shape and dtype of every input and pose leaf (starts, cloud rows, table
rows and dtype, masked or not).
Each graph has its own memory pool; an LRU per device evicts the least
recently used graphs while the pools and static buffers exceed
:data:`GRAPH_MEM_FRACTION` of the card (:func:`graph_stats` counts
captures, evictions and recaptures), and an evicted graph's pool goes with
its last reference.  On the CPU, under
``torch.autograd.set_detect_anomaly`` (``debug_nans``: it syncs the host,
which a capture cannot hold) and through the private ``_eager`` argument
the same step (:func:`_step_body`) runs as a Python loop on the same kind
of buffers (the two kernels on one cloud on the card, else the autograd
step; anomaly detection and the CPU always take the autograd step); the
graph replays that loop's kernels, so both give the same bits.

On a ('cand', 'point') mesh (``parallel``) a step splits in two:
each shard's loss sums and their pose gradient over its slice of the cloud
(:func:`_shard_step`), and each cand group's combine on its lead device,
which adds the shards' sums in shard order and takes the optimizer step
(:func:`_combine_step`).  :func:`mesh_run` captures both halves on their
own devices, cached like the single-device step (the key carries the
device, the shard and the group), and copies between them; the CPU and
``_eager`` run the same functions eagerly, with the same bits.

Two opt-in speed modes have no reference counterpart: the pruned descent
(every start for ``prune_iter`` iterations, then only the ``prune_keep``
best finish the budget) and the multi-resolution descent (the first
``low_iters`` iterations on a stride-downsampled table).  Both carry the
Adam and plateau state exactly across their split; each phase is a graph
of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
import time
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import torch

from .device import as_tensor, resolve_device
from .kernels import descent_step as kstep
from .loss import (
    Pose,
    masked_mean,
    pose_rotation,
    sampling_loss,
    sampling_loss_packed,
    sampling_partials_packed,
)
from .ops.rotation import rot_from_ypr
from .ops.sampling import (
    cast_packed_table,
    pack_bilinear_blocks,
    resolve_descent_table,
)
from .optim import AdamPlateauState, adam_plateau_step, init_adam_plateau
from .utils import profiling

__all__ = ["SolveResult", "descend", "evaluate_poses", "solve",
           "graph_stats", "descent_note", "GRAPH_MEM_FRACTION",
           "ShardInputs", "MeshGroup", "mesh_run"]
@dataclasses.dataclass
class SolveResult:
    """All starts' final states, in input order."""

    t: torch.Tensor  # (S, 3)
    ypr: torch.Tensor  # (S, 3)
    rot: torch.Tensor  # (S, 3, 3)
    loss: torch.Tensor  # (S,) loss evaluated before the last update
    lr: torch.Tensor  # (S,) final learning rates


def _check_prune(prune, num_iter: int, n_cand: int, trajectory: bool):
    """``(prune_iter, prune_keep)``, or None when pruning saves nothing (off,
    keeping every start, or no iteration after the split); raises on
    nonsensical combinations."""
    if prune is None:
        return None
    k, m = int(prune[0]), int(prune[1])
    if k <= 0 or m >= n_cand or k >= num_iter:
        return None
    if m < 1:
        raise ValueError(f"descent prune must keep >= 1 candidate, got {m}")
    if trajectory:
        raise ValueError(
            "trajectory=True is incompatible with descent pruning (pruned "
            "candidates have no post-prune states to visualize) — disable "
            "one of the two"
        )
    return (k, m)


def _check_multires(multires, num_iter: int, prune, trajectory: bool):
    """``(low_iters, stride)``, or None when there are no low-resolution
    iterations; raises on nonsensical combinations."""
    if multires is None:
        return None
    k, s = int(multires[0]), int(multires[1])
    if k <= 0:
        return None
    if s < 2:
        raise ValueError(f"multires stride must be >= 2, got {s}")
    if k >= num_iter:
        raise ValueError(
            f"multires low-res iterations ({k}) must leave full-res "
            f"refinement iterations (num_iter={num_iter})"
        )
    if prune is not None:
        raise ValueError(
            "descent multires and descent prune cannot combine (the prune "
            "split and the resolution split would need a shared schedule) "
            "— enable one of the two"
        )
    if trajectory:
        raise ValueError(
            "trajectory=True is incompatible with multires descent (the "
            "per-iteration losses change scale at the resolution switch, "
            "so the frames would not be comparable) — disable one"
        )
    return (k, s)


def _make_step_for(loss_fn, lo, hi, patience, factor):
    """One loss + Adam + plateau + clamp transition from a differentiable
    per-start pose loss; returns ``step(params, state) -> (params, state,
    loss)``."""

    def step(params: Pose, state):
        leaves = [p.detach().requires_grad_(True) for p in params.leaves()]
        with torch.enable_grad():
            loss = loss_fn(Pose(*leaves))
            grads = torch.autograd.grad(loss.sum(), leaves)
        loss = loss.detach()
        params, state = adam_plateau_step(
            Pose(*[p.detach() for p in leaves]), Pose(*grads), state, loss,
            patience, factor,
        )
        params.t = torch.clamp(params.t, lo, hi)
        return params, state, loss

    return step


class StepInputs(NamedTuple):
    """The tensors one descent step reads: a graph's static buffers."""

    blocks: torch.Tensor  # packed table, or K stacked tables
    xyz: torch.Tensor  # (N, 3), or (R, N, 3) with poses of leading (R, S)
    rgb: torch.Tensor
    point_mask: Optional[torch.Tensor]
    lo: torch.Tensor  # clamp box, broadcast against the poses' t
    hi: torch.Tensor
    row_offset: Optional[torch.Tensor]  # per-start table offset (stacked)


class StepStatics(NamedTuple):
    """The Python values baked into a step (part of a graph's key)."""

    height: int
    width: int
    patience: int
    factor: float
    wrap: bool


def _make_step(x: StepInputs, s: StepStatics):
    """The step on a packed sampling table built once by the caller."""
    return _make_step_for(
        lambda p: sampling_loss_packed(
            p, x.xyz, x.rgb, x.blocks, s.height, s.width, x.point_mask,
            wrap=s.wrap, row_offset=x.row_offset,
        ),
        x.lo, x.hi, s.patience, s.factor,
    )


def _packed_table(img, table_dtype: str, wrap: bool):
    return cast_packed_table(pack_bilinear_blocks(img, wrap=wrap), table_dtype)


def _state_leaves(params: Pose, state: AdamPlateauState):
    return (*params.leaves(), *state.m.leaves(), *state.v.leaves(),
            state.count, state.lr, state.best, state.num_bad)


def _from_leaves(leaves):
    return (Pose(*leaves[0:4]), AdamPlateauState(
        m=Pose(*leaves[4:8]), v=Pose(*leaves[8:12]), count=leaves[12],
        lr=leaves[13], best=leaves[14], num_bad=leaves[15]))


def _graphed(device: torch.device, eager: bool) -> bool:
    """The card runs the captured step unless the caller asks for the eager
    loop or anomaly detection (``debug_nans``) is on."""
    return (device.type == "cuda" and not eager
            and not torch.is_anomaly_enabled())


def descent_note(device) -> str:
    """What a printed route adds about the descent: the eager loop that
    ``debug_nans`` forces on the card, else nothing."""
    if torch.device(device).type == "cuda" and torch.is_anomaly_enabled():
        return ", eager descent (debug_nans)"
    return ""


def _contiguous(tensors):
    return [None if t is None
            else t.clone(memory_format=torch.contiguous_format)
            for t in tensors]


def _step_body(x: StepInputs, s: StepStatics, bufs, loss):
    """One step in place on the state leaves ``bufs`` and ``loss``, as the
    graph captures it and the eager loop runs it: the kernel pair where
    ``descent_step.engages``, else the autograd step."""
    if kstep.engages(x, bufs[0]):
        def body():
            # during a capture the partials come from the graph's own pool,
            # which keeps them for its replays, as it keeps autograd's
            # intermediates
            partials = kstep.scratch(x.xyz.shape[0], loss.shape[0],
                                     loss.device)
            kstep.descent_step(x, s, bufs, loss, partials)
        return body
    step = _make_step(x, s)

    def body():
        p, st, out = step(*_from_leaves(bufs))
        for dst, src in zip(bufs, _state_leaves(p, st)):
            dst.copy_(src)
        loss.copy_(out)
    return body


def _run(x: StepInputs, s: StepStatics, params, state, n: int,
         trajectory: bool = False, eager: bool = False):
    """``n`` steps; returns (params, state, last loss, trajectory): the
    trajectory a Pose whose leaves lead with (starts, n), else None."""
    profiling.count("descent.steps_kernel" if kstep.engages(x, params.t)
                    else "descent.steps_plain", n)
    if _graphed(params.t.device, eager):
        return _graph_for(x, s, params, state).run(x, params, state, n,
                                                   trajectory)
    x = StepInputs(*[None if t is None else t.contiguous() for t in x])
    bufs = _contiguous(_state_leaves(params, state))
    loss = torch.empty_like(bufs[1])
    body = _step_body(x, s, bufs, loss)
    states = []
    for _ in range(n):
        body()
        if trajectory:
            states.append([b.clone() for b in bufs[:4]])
    params, state = _from_leaves(bufs)
    traj = None
    if trajectory:
        traj = Pose(*[torch.stack(xs, dim=bufs[1].dim())
                      for xs in zip(*states)])
    return params, state, loss if n else None, traj


# ---------------------------------------------------------------------------
# the captured step

# the graphs' pools and static buffers on one device, as a share of its
# memory: the slab plans keep 9/16 of the card, and a multi-room service's
# keys take well under this (PERF.md, section 6)
GRAPH_MEM_FRACTION = 1 / 16
WARMUP_STEPS = 3
_GRAPHS: "OrderedDict[tuple, _StepGraph]" = OrderedDict()
_PENDING: "dict[tuple, threading.Event]" = {}  # keys being captured
_COUNTS = dict(captures=0, evictions=0, recaptures=0)
_EVICTED: set = set()
_GRAPHS_LOCK = threading.Lock()  # the cache's tables; never held long
# one capture at a time in the process: entering a capture empties the
# allocator's cache, which must not happen while another capture is open.
# Plan builds are not held off: they run on other streams, and the capture
# mode is thread-local (a build that runs out of memory during a capture
# fails into the gather engine, as any failed build does)
_CAPTURE_LOCK = threading.Lock()
_CAPTURES = itertools.count(1)


def _shapes(tensors):
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in tensors)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _capture(dev: torch.device, body):
    """Warm ``body`` up with ``WARMUP_STEPS`` eager runs on a side stream,
    then capture it on ``dev``; returns (graph, capture seconds with the
    warm-up, bytes of the graph's memory pool)."""
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                body()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a capture stream of this device: torch.cuda.graph's default one
        # belongs to the device of the process's first capture
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev),
                              capture_error_mode="thread_local"):
            body()
    capture_s = time.perf_counter() - t0
    pool = tuple(graph.pool())
    pool_bytes = sum(
        seg["total_size"] for seg in torch.cuda.memory_snapshot()
        if tuple(seg.get("segment_pool_id", ())) == pool)
    return graph, capture_s, pool_bytes


class _StepGraph:
    """One captured step over static buffers, and its replays.

    The buffers start as copies of the capturing call's inputs and state,
    on which ``WARMUP_STEPS`` steps run eagerly on a side stream first (the
    autograd engine and the allocator initialise lazily, and a capture must
    not see that); every call then copies its own values in.  Capture runs
    with ``capture_error_mode="thread_local"``: the plan-build, plan-save,
    prefetch, serving and HTTP threads may use the card meanwhile (their
    work goes to other streams and their allocations to the default pool),
    while a sync or an unsafe call from the capturing thread itself still
    fails the capture.
    """

    def __init__(self, key, x: StepInputs, s: StepStatics, params, state):
        self.key = key
        self.number = next(_CAPTURES)
        self.lock = threading.Lock()
        self.done = None  # event after the last call's clones
        self.replays = 0
        self.inputs = StepInputs(*_contiguous(x))
        self.bufs = _contiguous(_state_leaves(params, state))
        self.loss = torch.empty_like(self.bufs[1])
        self.kernel = kstep.engages(self.inputs, params.t)
        self.graph, self.capture_s, self.pool_bytes = _capture(
            params.t.device, _step_body(self.inputs, s, self.bufs, self.loss))
        self.static_bytes = _nbytes(*self.inputs, *self.bufs, self.loss)

    def run(self, x: StepInputs, params, state, n: int, trajectory: bool):
        """Copy ``x``, ``params`` and ``state`` in, replay ``n`` times and
        return clones, as :func:`_run` does."""
        dev = self.loss.device
        with self.lock, torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            if self.done is not None:  # a call on another stream
                stream.wait_event(self.done)
            for dst, src in zip(self.inputs, x):
                if dst is not None:
                    dst.copy_(src)
            for dst, src in zip(self.bufs, _state_leaves(params, state)):
                dst.copy_(src)
            traj = None
            if trajectory:
                traj = [torch.empty(t.shape[:1] + (n,) + t.shape[1:],
                                    dtype=t.dtype, device=t.device)
                        for t in self.bufs[:4]]
            for i in range(n):
                self.graph.replay()
                if trajectory:
                    for dst, src in zip(traj, self.bufs[:4]):
                        dst[:, i].copy_(src)
            self.replays += n
            p, st = _from_leaves([t.clone() for t in self.bufs])
            loss = self.loss.clone()
            self.done = torch.cuda.Event()
            self.done.record(stream)
        return p, st, loss, None if traj is None else Pose(*traj)

    def stats(self) -> dict:
        dev, statics, inputs, leaves = self.key
        return dict(capture=self.number, device=str(dev),
                    height=statics.height,
                    width=statics.width, starts=tuple(leaves[1][0]),
                    table=inputs[0][0], table_dtype=str(inputs[0][1]),
                    cloud=inputs[1][0], masked=inputs[3] is not None,
                    stacked=inputs[6] is not None, kernel=self.kernel,
                    capture_s=self.capture_s, pool_bytes=self.pool_bytes,
                    static_bytes=self.static_bytes, replays=self.replays)


def _graph_for(x: StepInputs, s: StepStatics, params, state) -> _StepGraph:
    """The cached graph for this shape key, captured on a miss."""
    key = (params.t.device, s, _shapes(x), _shapes(params.leaves()))
    return _cached_graph(key, lambda: _StepGraph(key, x, s, params, state))


def _cached_graph(key, make):
    """The cached graph for ``key`` (its device first), ``make()`` on a
    miss.  The lookup holds the cache lock only briefly: a capture runs
    outside it, so calls on other keys go on meanwhile, and calls missing
    the same key wait for its one capture (and capture it themselves if it
    failed)."""
    dev = key[0]
    while True:
        with _GRAPHS_LOCK:
            g = _GRAPHS.get(key)
            if g is not None:
                _GRAPHS.move_to_end(key)
                return g
            pending = _PENDING.get(key)
            if pending is None:
                pending = _PENDING[key] = threading.Event()
                break
        pending.wait()
    try:
        with _CAPTURE_LOCK:
            g = make()
        with _GRAPHS_LOCK:
            _COUNTS["captures"] += 1
            _COUNTS["recaptures"] += key in _EVICTED
            _GRAPHS[key] = g
            _evict(dev, key)
    finally:
        with _GRAPHS_LOCK:
            del _PENDING[key]
        pending.set()
    return g


def _evict(dev, keep) -> None:
    """Drop ``dev``'s least recently used graphs, never ``keep``, while its
    graphs' pools and static buffers exceed GRAPH_MEM_FRACTION of the card
    (a call still replaying an evicted graph keeps it alive)."""
    total = torch.cuda.get_device_properties(dev).total_memory
    cap = GRAPH_MEM_FRACTION * total
    mine = [k for k in _GRAPHS if k[0] == dev]
    held = sum(_GRAPHS[k].pool_bytes + _GRAPHS[k].static_bytes for k in mine)
    for k in mine:
        if held <= cap:
            break
        if k != keep:
            g = _GRAPHS.pop(k)
            held -= g.pool_bytes + g.static_bytes
            _COUNTS["evictions"] += 1
            _EVICTED.add(k)


def clear_graphs() -> None:
    """Drop every cached graph (a call still replaying one keeps it alive);
    the next call of each key captures it again, not counted as a
    recapture."""
    with _GRAPHS_LOCK:
        _GRAPHS.clear()
        _EVICTED.clear()


def graph_stats() -> dict:
    """``graphs``: one dict per cached graph, least recently used first (its
    capture's number in this process, its key's shapes, capture seconds
    with the warm-up, memory pool and static buffer bytes, replays so far);
    and the process's ``captures``, ``evictions`` and ``recaptures`` (a
    capture of a key evicted before)."""
    with _GRAPHS_LOCK:
        return dict(graphs=[g.stats() for g in _GRAPHS.values()], **_COUNTS)


# ---------------------------------------------------------------------------
# the descent


def _take(tree, idx: torch.Tensor):
    """Rows ``idx`` of every start-leading leaf of a Pose or optimizer
    state."""
    if isinstance(tree, Pose):
        return Pose(*[x[idx] for x in tree.leaves()])
    return AdamPlateauState(
        m=_take(tree.m, idx), v=_take(tree.v, idx), count=tree.count[idx],
        lr=tree.lr[idx], best=tree.best[idx], num_bad=tree.num_bad[idx])


def _descend_pruned(x, s, params, state, num_iter, prune_iter: int,
                    prune_keep: int, start_valid=None, eager=False):
    """Every start for ``prune_iter`` steps, then the ``prune_keep``
    lowest-loss survivors finish the budget with their whole optimizer state
    (moments, step count, learning rate, plateau best and counter).  Results
    come back in input order; pruned rows report their phase-1 state.

    One stable argsort gives disjoint survivor and pruned sets even on ties;
    ``start_valid`` False rows (clones of the best start) rank +inf, so a
    clone's identical phase-1 loss never takes a survivor slot.  On the card
    each phase is a graph of its own (the survivors are a second key); the
    argsort and the gathers between them run eagerly."""
    params1, state1, loss1, _ = _run(x, s, params, state, prune_iter,
                                     eager=eager)
    rank = loss1
    if start_valid is not None:
        rank = torch.where(start_valid, loss1, torch.full_like(loss1, math.inf))
    order = torch.argsort(rank, stable=True)
    keep, drop = order[:prune_keep], order[prune_keep:]
    params2, state2, loss2, _ = _run(x, s, _take(params1, keep),
                                     _take(state1, keep),
                                     num_iter - prune_iter, eager=eager)
    inv = torch.argsort(order)
    dropped = _take(params1, drop)
    params = Pose(*[torch.cat([a, b])[inv]
                    for a, b in zip(params2.leaves(), dropped.leaves())])
    losses = torch.cat([loss2, loss1[drop]])[inv]
    lrs = torch.cat([state2.lr, state1.lr[drop]])[inv]
    return params, losses, lrs


# ---------------------------------------------------------------------------
# the mesh descent: a cand group's starts over its point shards


class ShardInputs(NamedTuple):
    """One (cand, point) shard's inputs, on the shard's device: the packed
    table of the main image and the shard's slice of the cloud."""

    blocks: torch.Tensor
    xyz: torch.Tensor
    rgb: torch.Tensor
    point_mask: Optional[torch.Tensor]


class MeshGroup(NamedTuple):
    """A cand group: its point shards' inputs in shard order, and the clamp
    box on the group's lead device, where its optimizer state lives."""

    shards: Tuple[ShardInputs, ...]
    lo: torch.Tensor
    hi: torch.Tensor


def _pack_pose(params: Pose) -> torch.Tensor:
    """(S, 6) f32 [t, yaw, pitch, roll]: the poses each shard reads."""
    return torch.cat([params.t, params.yaw[:, None], params.pitch[:, None],
                      params.roll[:, None]], dim=1)


def _shard_step(x: ShardInputs, s: StepStatics,
                pose6: torch.Tensor) -> torch.Tensor:
    """A shard's loss sums at (S, 6) poses and their pose gradient, as
    (S, 8) f64 [total, count, d total / d (t, yaw, pitch, roll)]: every value
    is exact in f64, and one copy moves them to the group's lead."""
    leaves = [pose6[:, 0:3].clone(), pose6[:, 3].clone(),
              pose6[:, 4].clone(), pose6[:, 5].clone()]
    leaves = [t.requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        total, count = sampling_partials_packed(
            Pose(*leaves), x.xyz, x.rgb, x.blocks, s.height, s.width,
            x.point_mask, wrap=s.wrap)
        g_t, g_y, g_p, g_r = torch.autograd.grad(total.sum(), leaves)
    cols = [total.detach()[:, None], count[:, None], g_t, g_y[:, None],
            g_p[:, None], g_r[:, None]]
    return torch.cat([c.to(torch.float64) for c in cols], dim=1)


def _combine_step(parts: torch.Tensor, params: Pose, state, lo, hi,
                  patience: int, factor: float):
    """A group's step from its shards' (P, S, 8) sums: totals, counts and
    gradients added in shard order; the mean loss, and its gradient as the
    gradients' sum over max(count, 1) (the count is piecewise constant in
    the pose); then Adam + plateau and the translation clamp."""
    total = parts[0, :, 0].to(torch.float32)
    count = parts[0, :, 1].to(torch.int64)
    grad = parts[0, :, 2:].to(torch.float32)
    for p in range(1, parts.shape[0]):
        total = total + parts[p, :, 0].to(torch.float32)
        count = count + parts[p, :, 1].to(torch.int64)
        grad = grad + parts[p, :, 2:].to(torch.float32)
    loss = masked_mean(total, count)
    grad = torch.where((count > 0)[:, None],
                       grad / count.clamp_min(1)[:, None],
                       torch.zeros_like(grad))
    params, state = adam_plateau_step(
        params, Pose(t=grad[:, 0:3], yaw=grad[:, 3], pitch=grad[:, 4],
                     roll=grad[:, 5]),
        state, loss, patience, factor)
    params.t = torch.clamp(params.t, lo, hi)
    return params, state, loss


class _ShardGraph:
    """A shard's :func:`_shard_step` captured over static buffers: the
    inputs are copied in once a call, the poses before every replay, and
    the packed sums are read out after it.  Groups whose shards share a
    device and a point slice share this graph (it keeps no state between
    replays)."""

    def __init__(self, key, x: ShardInputs, s: StepStatics, pose6):
        self.key = key
        self.number = next(_CAPTURES)
        self.lock = threading.Lock()
        self.done = None
        self.replays = 0
        self.device = pose6.device
        self.inputs = ShardInputs(*[None if t is None else t.clone()
                                    for t in x])
        self.pose6 = pose6.clone()
        self.out = torch.empty((pose6.shape[0], 8), dtype=torch.float64,
                               device=self.device)

        def body():
            self.out.copy_(_shard_step(self.inputs, s, self.pose6))

        self.graph, self.capture_s, self.pool_bytes = _capture(self.device,
                                                               body)
        self.static_bytes = _nbytes(*self.inputs, self.pose6, self.out)

    def stats(self) -> dict:
        dev, kind, shard, statics, inputs, starts = self.key
        return dict(capture=self.number, device=str(dev), kind=kind,
                    shard=shard, height=statics.height, width=statics.width,
                    starts=starts, table=inputs[0][0],
                    table_dtype=str(inputs[0][1]), cloud=inputs[1][0],
                    masked=inputs[3] is not None, stacked=False,
                    capture_s=self.capture_s, pool_bytes=self.pool_bytes,
                    static_bytes=self.static_bytes, replays=self.replays)


class _CombineGraph:
    """A group's :func:`_combine_step` captured on its lead device over the
    shards' sums, the optimizer state and the poses it writes for the next
    replay of the shards."""

    def __init__(self, key, s: StepStatics, n_point: int, params, state, lo,
                 hi):
        self.key = key
        self.number = next(_CAPTURES)
        self.lock = threading.Lock()
        self.done = None
        self.replays = 0
        self.device = lo.device
        starts = params.yaw.shape[0]
        self.parts = torch.zeros((n_point, starts, 8), dtype=torch.float64,
                                 device=self.device)
        self.bufs = [t.clone() for t in _state_leaves(params, state)]
        self.lo, self.hi = lo.clone(), hi.clone()
        self.loss = torch.empty_like(params.yaw)
        self.pose6 = _pack_pose(params)

        def body():
            p, st, loss = _combine_step(self.parts, *_from_leaves(self.bufs),
                                        self.lo, self.hi, s.patience,
                                        s.factor)
            for dst, src in zip(self.bufs, _state_leaves(p, st)):
                dst.copy_(src)
            self.loss.copy_(loss)
            self.pose6.copy_(_pack_pose(p))

        self.graph, self.capture_s, self.pool_bytes = _capture(self.device,
                                                               body)
        self.static_bytes = _nbytes(self.parts, *self.bufs, self.lo, self.hi,
                                    self.loss, self.pose6)

    def stats(self) -> dict:
        dev, kind, group, n_point, _, _, leaves = self.key
        return dict(capture=self.number, device=str(dev), kind=kind,
                    group=group, shards=n_point, starts=tuple(leaves[1][0]),
                    capture_s=self.capture_s, pool_bytes=self.pool_bytes,
                    static_bytes=self.static_bytes, replays=self.replays)


def _mesh_run_eager(groups, s, params, states, n):
    out = []
    for g, p, st in zip(groups, params, states):
        loss = None
        for _ in range(n):
            pose6 = _pack_pose(p)
            parts = torch.stack([
                _shard_step(x, s, pose6.to(x.xyz.device)).to(g.lo.device)
                for x in g.shards])
            p, st, loss = _combine_step(parts, p, st, g.lo, g.hi, s.patience,
                                        s.factor)
        out.append((p, st, loss))
    return out


def mesh_run(groups, s: StepStatics, params, states, n: int,
             eager: bool = False):
    """``n`` steps of every cand group's descent; ``params[g]`` and
    ``states[g]`` are group g's starts and optimizer state on its lead
    device.  Returns per group (params, state, last loss).

    Each step: the group's poses go to its shards, each shard's loss sums
    and their gradient come back to the lead (:func:`_shard_step`), and the
    lead adds them in shard order and takes the optimizer step
    (:func:`_combine_step`).  On the card each shard's step and each
    group's combine are captured graphs on their own devices, keyed and
    cached like the single-device step; the copies between them run
    outside the graphs, and torch's cross-device copies order the cards'
    streams.  The poses go out to every shard before any shard replays, so
    the shards of a group run at once.  On the CPU and with ``eager`` the
    same functions run one op at a time, so both give the same bits."""
    if not _graphed(groups[0].lo.device, eager):
        return _mesh_run_eager(groups, s, params, states, n)
    plan = []
    for c, (g, p, st) in enumerate(zip(groups, params, states)):
        pose6 = _pack_pose(p)
        shard_graphs = []
        for i, x in enumerate(g.shards):
            dev = x.xyz.device
            key = (dev, "mesh shard", i, s, _shapes(x), tuple(pose6.shape))
            shard_graphs.append(_cached_graph(
                key, lambda key=key, x=x, dev=dev: _ShardGraph(
                    key, x, s, pose6.to(dev))))
        key = (g.lo.device, "mesh combine", c, len(g.shards), s.patience,
               s.factor, _shapes(p.leaves()))
        combine = _cached_graph(
            key, lambda key=key, g=g, p=p, st=st: _CombineGraph(
                key, s, len(g.shards), p, st, g.lo, g.hi))
        plan.append((shard_graphs, combine))
    graphs = sorted({id(gr): gr for sgs, cg in plan
                     for gr in (*sgs, cg)}.values(), key=lambda gr: gr.number)
    with contextlib.ExitStack() as held:
        for gr in graphs:  # one order for every caller: no deadlock
            held.enter_context(gr.lock)
        for gr in graphs:
            if gr.done is not None:  # a call on another stream
                torch.cuda.current_stream(gr.device).wait_event(gr.done)
        filled = set()
        for g, (sgs, cg), p, st in zip(groups, plan, params, states):
            for x, sg in zip(g.shards, sgs):
                if id(sg) not in filled:
                    filled.add(id(sg))
                    for dst, src in zip(sg.inputs, x):
                        if dst is not None:
                            dst.copy_(src)
            for dst, src in zip(cg.bufs, _state_leaves(p, st)):
                dst.copy_(src)
            cg.lo.copy_(g.lo)
            cg.hi.copy_(g.hi)
            cg.pose6.copy_(_pack_pose(p))
        for _ in range(n):
            for sgs, cg in plan:
                for sg in sgs:
                    sg.pose6.copy_(cg.pose6)
                for sg in sgs:
                    with torch.cuda.device(sg.device):
                        sg.graph.replay()
                    sg.replays += 1
                for i, sg in enumerate(sgs):
                    cg.parts[i].copy_(sg.out)
                with torch.cuda.device(cg.device):
                    cg.graph.replay()
                cg.replays += 1
        out = []
        for _, cg in plan:
            p, st = _from_leaves([t.clone() for t in cg.bufs])
            out.append((p, st, cg.loss.clone()))
        for gr in graphs:
            gr.done = torch.cuda.Event()
            gr.done.record(torch.cuda.current_stream(gr.device))
    return out


def descend_packed(x: StepInputs, s: StepStatics, t0s, ypr0s, num_iter: int,
                   lr: float, trajectory: bool = False, _eager: bool = False):
    """Descend starts of any leading shape ((S,), or (R, S) against a stack
    of R clouds, or (K,) on K stacked tables through ``x.row_offset``) on a
    packed table built by the caller, from a fresh optimizer state.  Returns
    ``(params, losses, lrs, traj)`` as :func:`descend_starts` does."""
    params = Pose(t=t0s, yaw=ypr0s[..., 0], pitch=ypr0s[..., 1],
                  roll=ypr0s[..., 2])
    state = init_adam_plateau(params, lr)
    params, state, loss, traj = _run(x, s, params, state, num_iter,
                                     trajectory, eager=_eager)
    return params, loss, state.lr, traj


def descend_starts(img, xyz, rgb, t0s, ypr0s, lo, hi, point_mask, num_iter,
                   lr, patience, factor, table_dtype="float32", wrap=False,
                   trajectory=False, prune=None, multires=None,
                   table_arg="auto", start_valid=None, _eager=False):
    """Descend (S, 3) starts for ``num_iter`` iterations on (H, W, 3)
    ``img``, with its packed table in ``table_dtype``.

    ``prune``/``multires`` select the speed modes (validated here; the
    multi-resolution table resolves its own dtype from ``table_arg``).
    Returns ``(params, losses, lrs, traj)``; ``traj`` is a Pose whose leaves
    lead with (S, num_iter) when ``trajectory`` is set, else None.  On the
    card the iterations replay the captured step; ``_eager=True`` runs the
    eager loop there instead (the reference the graph is held against)."""
    H, W, _ = img.shape
    prune = _check_prune(prune, num_iter, t0s.shape[0], trajectory)
    multires = _check_multires(multires, num_iter, prune, trajectory)
    x = StepInputs(_packed_table(img, table_dtype, wrap), xyz, rgb,
                   point_mask, lo, hi, None)
    s = StepStatics(H, W, int(patience), float(factor), bool(wrap))
    if multires is None and prune is None:
        return descend_packed(x, s, t0s, ypr0s, num_iter, lr, trajectory,
                              _eager)
    params = Pose(t=t0s, yaw=ypr0s[:, 0], pitch=ypr0s[:, 1],
                  roll=ypr0s[:, 2])
    state = init_adam_plateau(params, lr)
    if prune is not None:
        params, losses, lrs = _descend_pruned(
            x, s, params, state, num_iter, prune[0], prune[1],
            start_valid=start_valid, eager=_eager,
        )
        return params, losses, lrs, None
    # the first k_low iterations on img[::s, ::s], whose table resolves its
    # own dtype (a small table stays f32 under auto); the final loss is a
    # full-resolution one
    k_low, stride = multires
    img_lo = img[::stride, ::stride].contiguous()
    h_lo, w_lo = int(img_lo.shape[0]), int(img_lo.shape[1])
    x_lo = x._replace(blocks=_packed_table(
        img_lo, resolve_descent_table(table_arg, h_lo, w_lo, img_lo.device),
        wrap))
    params, state, _, _ = _run(x_lo, s._replace(height=h_lo, width=w_lo),
                               params, state, k_low, eager=_eager)
    params, state, loss, _ = _run(x, s, params, state, num_iter - k_low,
                                  eager=_eager)
    return params, loss, state.lr, None


def descend(img, xyz, rgb, trans0, ypr0, lo, hi,
            point_mask: Optional[torch.Tensor] = None, *, num_iter: int = 100,
            lr: float = 0.1, patience: int = 5, factor: float = 0.9,
            masked: bool = False, trajectory: bool = False,
            table_dtype: str = "auto", wrap: bool = False,
            prune: Optional[Tuple[int, int]] = None,
            multires: Optional[Tuple[int, int]] = None,
            start_valid=None, device="cuda", _eager: bool = False):
    """Descend all candidates in parallel; returns a :class:`SolveResult`
    (and the trajectory Pose when ``trajectory``).

    ``prune=(prune_iter, prune_keep)``: after ``prune_iter`` steps only the
    ``prune_keep`` lowest-loss candidates finish the budget; pruned rows
    report their frozen phase-1 state.  ``multires=(low_iters, stride)``:
    the first ``low_iters`` iterations sample a stride-downsampled table.
    Both are off by default (the reference descends every start at one
    resolution), and neither combines with the other or with
    ``trajectory``.  ``start_valid`` (S,) bool marks clone rows False so
    they never take a survivor slot.  ``_eager``: as
    :func:`descend_starts`."""
    dev = resolve_device(device)
    img = as_tensor(img, dev, torch.float32)
    xyz = as_tensor(xyz, dev, torch.float32)
    rgb = as_tensor(rgb, dev, torch.float32)
    pm = as_tensor(point_mask, dev, torch.bool) if masked else None
    sv = None if start_valid is None else as_tensor(start_valid, dev,
                                                    torch.bool)
    H, W, _ = img.shape
    params, losses, lrs, traj = descend_starts(
        img, xyz, rgb, as_tensor(trans0, dev, torch.float32),
        as_tensor(ypr0, dev, torch.float32), as_tensor(lo, dev, torch.float32),
        as_tensor(hi, dev, torch.float32), pm, num_iter, lr, patience, factor,
        resolve_descent_table(table_dtype, H, W, dev), wrap, trajectory,
        prune=prune, multires=multires, table_arg=table_dtype,
        start_valid=sv, _eager=_eager,
    )
    result = SolveResult(t=params.t, ypr=params.ypr(),
                         rot=pose_rotation(params), loss=losses, lr=lrs)
    if trajectory:
        return result, traj
    return result


def evaluate_poses(img, xyz, rgb, trans, ypr, point_mask=None, *,
                   masked: bool = False, device="cuda"):
    """One-shot loss of candidate poses on the unpacked sampling loss (no
    descent); returns (losses (B,), rotations (B, 3, 3))."""
    dev = resolve_device(device)
    ypr = as_tensor(ypr, dev, torch.float32)
    pose = Pose(t=as_tensor(trans, dev, torch.float32), yaw=ypr[:, 0],
                pitch=ypr[:, 1], roll=ypr[:, 2])
    pm = as_tensor(point_mask, dev, torch.bool) if masked else None
    losses = sampling_loss(pose, as_tensor(xyz, dev, torch.float32),
                           as_tensor(rgb, dev, torch.float32),
                           as_tensor(img, dev, torch.float32), pm)
    return losses, rot_from_ypr(ypr)


def solve(img, xyz, rgb, trans0, ypr0, lo, hi, point_mask=None, **kw):
    """Run :func:`descend` and select the minimum-loss candidate (the first
    among equal losses); returns (t (3,), R (3, 3), loss (), SolveResult)."""
    res = descend(img, xyz, rgb, trans0, ypr0, lo, hi, point_mask,
                  masked=point_mask is not None, **kw)
    k = torch.argmin(res.loss)
    return res.t[k], res.rot[k], res.loss[k], res
