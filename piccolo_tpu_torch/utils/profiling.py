"""Profiling and tracing hooks (port of piccolo_tpu/utils/profiling.py).

Per-query wall timing stays in the harness CSV.  ``profile_dir`` turns on
a ``torch.profiler`` trace around each query (:func:`maybe_trace`), the
counterpart of ``jax.profiler.trace``; ``debug_nans`` turns on autograd's
anomaly detection (:func:`enable_nan_debug`), the reference's always-on
``torch.autograd.set_detect_anomaly``.  The port compiles no XLA programs:
what a fresh process would compile again is its kernel libraries, so the
compilation cache is the directory they are built into
(:func:`enable_compilation_cache`).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import re
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ["Timer", "maybe_trace", "enable_nan_debug", "enable_compilation_cache"]

# the environment's build directory, as PICCOLO_XLA_CACHE_DIR is the JAX
# package's compilation cache; an explicit path still wins
CACHE_DIR_ENV = "PICCOLO_TORCH_CACHE_DIR"

_TRACES = itertools.count()
# one-element kernels that open every trace with cards (maybe_trace)
TRACE_WARMUP_KERNELS = 256


def enable_compilation_cache(path: Optional[str] = None) -> Path:
    """Build and keep the port's kernel libraries (``kernels/_build.py``:
    the CUDA kernels and the JPEG codec) in ``path``, or in
    ``$PICCOLO_TORCH_CACHE_DIR``, or by default in the package's own
    ``kernels/_build/``.  A library is found there by the hash of its
    source, flags and platform and checked against its digest, so a fresh
    process loads it instead of running the compiler again.  A library
    this process loaded already stays loaded.  Safe to call repeatedly;
    returns the directory."""
    from ..kernels import _build

    return _build.use_dir(path or os.environ.get(CACHE_DIR_ENV)
                          or _build.BUILD_DIR).path


class Timer:
    """Context-manager wall timer: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self):
        self._start = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self._start
        return False


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str], name: str = "query",
                warmup_kernels: int = TRACE_WARMUP_KERNELS):
    """A ``torch.profiler`` trace of the block when a directory is
    configured, a no-op otherwise.

    It records the host's operators and, where a card is present, its
    kernels (CUPTI), and writes one Chrome trace a block into
    ``profile_dir``: ``<name>-<pid>-<n>.pt.trace.json``, ``n`` counting this
    process's traces.  A trace with cards opens with ``warmup_kernels``
    one-element kernels on each card (under ``maybe_trace.warmup``), and
    the cards are synchronised before the trace starts, after those
    kernels and before the trace stops.  On
    the H100 a profiler session in a process that has run for some minutes
    loses the first device records it would hold (0 at first, 13 after
    four minutes of ``chip_smoke.py``'s phases), and the warm-up kernels
    take that loss in place of the block's first kernels.  Yields the
    profiler (None when off), whose ``key_averages()`` can be read after
    the block."""
    if not profile_dir:
        yield None
        return
    out = Path(os.path.expanduser(str(profile_dir)))
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    cards = range(torch.cuda.device_count() if torch.cuda.is_available()
                  else 0)
    if cards:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    stem = re.sub(r"[^\w.-]", "_", name) or "query"
    for i in cards:
        torch.cuda.synchronize(i)
    with torch.profiler.profile(activities=acts) as prof:
        _warm_up(cards, warmup_kernels)
        yield prof
        for i in cards:
            torch.cuda.synchronize(i)
    prof.export_chrome_trace(
        str(out / f"{stem}-{os.getpid()}-{next(_TRACES)}.pt.trace.json"))


def _warm_up(cards, n: int) -> None:
    """``n`` one-element kernels on each card, then wait for every card."""
    if not cards:
        return
    with torch.profiler.record_function("maybe_trace.warmup"):
        for i in cards:
            x = torch.zeros(1, device=torch.device("cuda", i))
            for _ in range(n):
                x.add_(1)
    for i in cards:
        torch.cuda.synchronize(i)


def enable_nan_debug(enable: bool = True) -> None:
    """Autograd's anomaly detection: a backward that produces a NaN raises,
    naming the forward operator.  Debug runs only: it checks every
    operator, and the descent runs its eager loop under it."""
    torch.autograd.set_detect_anomaly(enable)
