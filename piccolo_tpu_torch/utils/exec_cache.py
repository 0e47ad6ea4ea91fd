"""The executable cache: what a fresh process would build again, kept on
disk across processes (port of piccolo_tpu/utils/exec_cache.py).

The JAX package serializes compiled XLA executables, because on its TPU
front end a fresh process spends most of its warm-up compiling.  The port
compiles no XLA programs, and its compiled descent, a CUDA graph, cannot
be serialized.  A fresh process of the port pays instead (measured on the
card, ``scripts/measure_coldstart_cuda.py``; PERF.md): the ``nvcc`` builds
of its kernel libraries and the host build of its JPEG codec, the room's
plan builds, one graph capture per shape key, and the first run of each
PyTorch kernel.  Of these only the built libraries can be reloaded: a plan
builds on the card faster than it loads from the disk, and a graph is
captured anew in every process.  So the cache holds the libraries.

It is the process's library store (``kernels/_build.BuildDir``), the one
every build goes through, pointed at ``exec_cache_dir``: entries keyed by
source, flags and platform (torch, CUDA, ``nvcc``, the card), as the JAX
key hashes the program and a platform fingerprint, each checked against
its digest before a load and built again over a bad one.  The default
build directory keeps the libraries across processes the same way; what
``exec_cache_dir`` adds is a directory of the caller's choice, every
library built or loaded before the first query (:func:`warm`), and a line
saying what it found (:func:`describe`).

In memory the JAX module memoizes one compiled executable per signature.
Here that memo is the descent's graph LRU (``solver.py``), keyed by shapes
and statics, so:

  * :func:`aot_call` warms the cache directory (once a process and
    directory), then calls the function; ``static_names`` is accepted for
    the JAX signature and not used (the graph key covers the statics);
  * :func:`clear_memo` empties the graph LRU and forgets the warmed
    directories;
  * :func:`evict_lru` trims a directory to a byte budget, least recently
    loaded libraries first.  Nothing calls it on its own: the port keeps a
    handful of libraries, not one program a shape.
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

from ..kernels import _build

__all__ = ["aot_call", "clear_memo", "evict_lru", "warm", "describe"]

_DEFAULT_MAX_BYTES = 2 << 30

_lock = threading.Lock()
_warmed: Dict[tuple, dict] = {}  # (dir, cuda) -> stats


def warm(cache_dir, device="cuda") -> dict:
    """Point this process's library store at ``cache_dir``
    (``kernels/_build.use_dir``) and build or load every library there:
    the CUDA kernels (one ``nvcc`` each, all started together) when
    ``device`` is a card, and the JPEG codec.  Once a process and
    directory; returns what it found: ``dir``, ``hits``, ``built``,
    ``rebuilt`` (library names) and ``seconds``."""
    from ..harness import imaging

    path = Path(os.path.expanduser(str(cache_dir))).resolve()
    cuda = torch.device(device).type == "cuda"
    key = (str(path), cuda)
    with _lock:
        store = _build.use_dir(path)
        if key in _warmed:
            return _warmed[key]
        t0 = time.perf_counter()
        seen = [len(store.hits), len(store.built_names), len(store.rebuilt)]
        jobs = [(_build.CSRC / f"{n}.cu", None, _build.NVCC_FLAGS)
                for n in _build.KERNEL_SOURCES] if cuda else []
        _build.build_sources(jobs + [_build.host_job(imaging.CODEC_SRC)])
        stats = dict(dir=str(path), hits=store.hits[seen[0]:],
                     built=store.built_names[seen[1]:],
                     rebuilt=store.rebuilt[seen[2]:])
        if cuda:
            for name in _build.KERNEL_SOURCES:
                _build.load_library(name)
        imaging._codec()
        stats["seconds"] = time.perf_counter() - t0
        _warmed[key] = stats
        return stats


def describe(stats: dict) -> str:
    """One line for a log: the directory, its hits and its builds."""
    return (f"exec cache: {stats['dir']}: {len(stats['hits'])} hit(s), "
            f"{len(stats['built'])} built, {len(stats['rebuilt'])} rebuilt "
            f"over a corrupt entry, {stats['seconds']:.2f} s")


def evict_lru(cache_dir: str, max_bytes: int = _DEFAULT_MAX_BYTES,
              keep: str = "") -> int:
    """Delete least recently loaded libraries (``.so`` and digest) until
    the directory fits ``max_bytes``, never ``keep``.  Returns the number
    of libraries removed."""
    entries = []
    total = 0
    try:
        names: Iterable[str] = os.listdir(cache_dir)
    except OSError:
        return 0
    for n in names:
        if not n.endswith(".so"):
            continue
        p = os.path.join(cache_dir, n)
        try:
            st = os.stat(p)
        except OSError:
            continue
        entries.append((st.st_mtime, st.st_size, n))
        total += st.st_size
    removed = 0
    for _, size, n in sorted(entries):
        if total <= max_bytes:
            break
        if n == keep:
            continue
        p = os.path.join(cache_dir, n)
        try:
            os.unlink(p)
        except OSError:
            continue
        try:
            os.unlink(p + _build.DIGEST)
        except OSError:
            pass
        total -= size
        removed += 1
    return removed


def clear_memo() -> None:
    """Empty the descent's graph LRU and forget the warmed directories (the
    next :func:`warm` checks its entries again).  Loaded libraries stay
    loaded."""
    from .. import solver

    solver.clear_graphs()
    with _lock:
        _warmed.clear()


def aot_call(fn, static_names, cache_dir, *args, **kwargs):
    """``fn(*args, **kwargs)`` with this process's libraries from
    ``cache_dir`` (:func:`warm` on ``kwargs["device"]``, the card by
    default).  ``static_names``: the JAX signature's static argument names,
    not used here."""
    del static_names
    warm(cache_dir, kwargs.get("device", "cuda"))
    return fn(*args, **kwargs)
