"""Disk persistence for slab grid plans (port of
piccolo_tpu/kernels/plan_cache.py).

A GridPlan is a pure function of (cloud, candidate grids, init-image size,
layout flags), all room-static.  Plans are saved under a content-addressed
key, a digest of those exact inputs plus a format version, so any change
to them misses by construction.  Writes are atomic (tmp file + rename) and
the directory is kept to a byte budget by mtime-LRU eviction.

The key, the format version and the npz layout are the JAX package's: the
key digests numpy views of the same arrays, so both packages compute equal
keys, and a plan saved by either loads in the other.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time
import zipfile
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .slab_sampling import GridPlan

__all__ = [
    "plan_key",
    "save_plan",
    "load_plan",
    "evict_lru",
    "default_plan_cache_dir",
    "PLAN_FORMAT_VERSION",
]

# the JAX package's version: v4 added the q8 layout flag to the aux record
PLAN_FORMAT_VERSION = 4


def default_plan_cache_dir() -> str:
    """The JAX package's cache directory, shared: the formats are one."""
    return os.path.join(
        os.path.expanduser("~"), ".cache", "piccolo_tpu", "plans"
    )


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _digest_array(h, a) -> None:
    a = _host(a)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())


def plan_key(xyz, rgb, point_mask, trans_grid, rot_grid, height: int,
             width: int, compact: bool, tp_is_pid: bool, wrap: bool = False,
             window=None, block=None, quant: bool = False) -> str:
    """Content digest of everything a plan is a function of."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"v{PLAN_FORMAT_VERSION}".encode())
    _digest_array(h, xyz)
    _digest_array(h, rgb)
    if point_mask is not None:
        _digest_array(h, point_mask)
    else:
        h.update(b"nomask")
    _digest_array(h, trans_grid)
    _digest_array(h, rot_grid)
    h.update(
        f"{height}x{width}:{int(compact)}{int(tp_is_pid)}{int(wrap)}"
        f"{int(quant)}".encode()
    )
    if window is not None or block is not None:
        # explicit geometry changes plan contents; the auto geometry is a
        # function of the hashed inputs
        h.update(f"g{window}x{block}".encode())
    return h.hexdigest()


def _path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"plan_{key}.npz")


def save_plan(cache_dir: str, key: str, plan: GridPlan,
              max_bytes: Optional[int] = None) -> str:
    """Persist a plan atomically; optionally evict LRU entries to budget.
    Copies the plan to host memory: call it off the query path."""
    os.makedirs(cache_dir, exist_ok=True)
    # all groups share one padded block count, so they stack
    fields = np.stack([_host(f) for f in plan.fields])
    windows = np.stack([_host(w) for w in plan.windows])
    tps = (np.stack([_host(t) for t in plan.tps])
           if plan.tps else np.zeros((0,), np.float32))
    aux = np.array(
        [plan.n_pairs, int(plan.compact), int(plan.tp_is_pid),
         plan.height, plan.width, int(plan.wrap),
         plan.window, plan.block, int(plan.quant)],
        np.int64,
    )
    path = _path(cache_dir, key)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, fields=fields, windows=windows, tps=tps, aux=aux)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if max_bytes is not None:
        evict_lru(cache_dir, max_bytes)
    return path


def load_plan(cache_dir: str, key: str, device="cuda") -> Optional[GridPlan]:
    """Load a cached plan onto ``device``; None on a miss or a corrupt
    entry (which is deleted)."""
    dev = resolve_device(device)
    path = _path(cache_dir, key)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            fields = z["fields"]
            windows = z["windows"]
            tps = z["tps"]
            aux = z["aux"]
    except (zipfile.BadZipFile, KeyError, ValueError, EOFError):
        # half-written or foreign file: a miss, and delete it
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
    except Exception:
        # transient failure (memory pressure, interrupted read): a miss
        # without deleting an entry that is likely fine
        return None
    try:
        os.utime(path)  # LRU touch
    except OSError:
        pass  # concurrently evicted: the data is already in memory
    (n_pairs, compact, tp_is_pid, height, width, wrap, window, block,
     quant) = (int(v) for v in aux)
    return GridPlan(
        fields=tuple(torch.from_numpy(f).to(dev) for f in fields),
        windows=tuple(torch.from_numpy(w).to(dev) for w in windows),
        n_pairs=n_pairs, height=height, width=width, wrap=bool(wrap),
        window=window, block=block, compact=bool(compact),
        tp_is_pid=bool(tp_is_pid), quant=bool(quant),
        tps=tuple(torch.from_numpy(t).to(dev) for t in tps) if tps.size
        else (),
    )


def evict_lru(cache_dir: str, max_bytes: int) -> int:
    """Delete oldest-touched plans until the directory fits the budget, and
    .tmp orphans older than an hour.  Returns the entries removed."""
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return 0
    for n in names:
        if n.endswith(".tmp"):
            p = os.path.join(cache_dir, n)
            try:
                if time.time() - os.path.getmtime(p) > 3600:
                    os.unlink(p)
            except OSError:
                pass
    entries = []
    for n in names:
        if not n.endswith(".npz"):
            continue
        p = os.path.join(cache_dir, n)
        try:
            entries.append((os.path.getmtime(p), os.path.getsize(p), p))
        except OSError:
            continue  # raced with another process's eviction
    total = sum(s for _, s, _ in entries)
    removed = 0
    for _, size, path in sorted(entries):
        if total <= max_bytes:
            break
        try:
            os.unlink(path)
            total -= size
            removed += 1
        except OSError:
            pass
    return removed
