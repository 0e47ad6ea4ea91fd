"""Profiling and tracing hooks (port of piccolo_tpu/utils/profiling.py).

Per-query wall timing stays in the harness CSV.  ``profile_dir`` turns on
a ``torch.profiler`` trace around each query (:func:`maybe_trace`), the
counterpart of ``jax.profiler.trace``; ``debug_nans`` turns on autograd's
anomaly detection (:func:`enable_nan_debug`), the reference's always-on
``torch.autograd.set_detect_anomaly``.  The port compiles no XLA programs:
what a fresh process would compile again is its kernel libraries, so the
compilation cache is the directory they are built into
(:func:`enable_compilation_cache`).

Spans and counters (:func:`span`, :func:`request`, :func:`count`,
:func:`record`) name the program's layers while a ``torch.profiler``
session records, whichever thread opened it.  A span is then a host range
in the profiler's trace (so it labels the device's idle time) and one
record in a bounded in-memory store: its name, start and end on
``time.time_ns()``'s clock, thread, the request id(s) it belongs to, its
parent span and its attributes.  A request id is opened
once, at admission (:func:`request`), and nested spans on the same thread
inherit it.  :func:`span_records` is the store's one reader.  With no
session open a span is one flag check and a shared no-op context.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import re
import threading
import time
from collections import deque
from pathlib import Path
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["maybe_trace", "enable_nan_debug", "enable_compilation_cache",
           "span", "request", "count", "record", "current_requests",
           "span_records", "tracing", "SpanRecord"]

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


# records the store keeps; the oldest go first
STORE_SIZE = 1 << 16


class SpanRecord(NamedTuple):
    """One span or counter in the store.  A counter starts and ends at the
    moment it was counted and carries its amount in ``n``; a span's ``n``
    is None."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    requests: tuple
    parent: Optional[int]
    id: int
    attrs: dict
    n: Optional[int] = None


_STORE: deque = deque(maxlen=STORE_SIZE)
_IDS = itertools.count(1)
_REQUESTS: contextvars.ContextVar = contextvars.ContextVar(
    "piccolo_requests", default=())
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "piccolo_span", default=None)
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """True while a ``torch.profiler`` session records, on every thread of
    the process (the profiler's own flag, set by whichever thread opened
    the session)."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "requests", "attrs", "id", "parent", "start",
                 "_rf", "_tokens")

    def __init__(self, name: str, requests, attrs: dict):
        self.name, self.requests, self.attrs = name, requests, attrs

    def __enter__(self):
        # stamped before the range opens: the profiler stamps its event
        # early in the range's entry, whose first call on a thread then
        # takes a millisecond or more
        self.start = time.time_ns()
        # a host op, not record_function's user annotation: the profiler
        # gives an annotation a device-side row over every kernel launched
        # under it, which a trace reader would count as device work
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        up = _OPEN.get()
        self.parent = None if up is None else up.id
        self.id = next(_IDS)
        if self.requests is None:
            self.requests = _REQUESTS.get()
        self._tokens = (_OPEN.set(self), _REQUESTS.set(self.requests))
        return self

    def __exit__(self, *exc):
        _STORE.append(SpanRecord(
            self.name, self.start, time.time_ns(), threading.get_ident(),
            self.requests, self.parent, self.id, self.attrs))
        _REQUESTS.reset(self._tokens[1])
        _OPEN.reset(self._tokens[0])
        return self._rf.__exit__(*exc)


def span(name: str, *, requests: Optional[tuple] = None, **attrs):
    """A context that, while tracing, opens a host range ``name`` in the
    profiler's trace and stores the span.  ``requests`` names the request
    ids the span works for (default: the enclosing span's); spans opened
    inside it inherit them."""
    if not tracing():
        return _OFF
    return _Span(name, None if requests is None else tuple(requests), attrs)


def request(name: str, **attrs):
    """A request's root span: while tracing, a new request id that every
    span opened inside it on this thread carries."""
    if not tracing():
        return _OFF
    return _Span(name, (next(_IDS),), attrs)


def current_requests() -> tuple:
    """The request ids of the innermost open span, () outside any."""
    return _REQUESTS.get()


def count(name: str, n: int = 1) -> None:
    """While tracing, store ``n`` of ``name`` for the current request."""
    if tracing():
        now = time.time_ns()
        up = _OPEN.get()
        _STORE.append(SpanRecord(
            name, now, now, threading.get_ident(), _REQUESTS.get(),
            None if up is None else up.id, next(_IDS), {}, int(n)))


def record(name: str, start_ns: int, end_ns: int, *,
           requests: Optional[tuple] = None) -> None:
    """While tracing, store a span whose interval is already over (a wait
    that another thread ends), under the innermost open span."""
    if tracing():
        up = _OPEN.get()
        _STORE.append(SpanRecord(
            name, int(start_ns), int(end_ns), threading.get_ident(),
            _REQUESTS.get() if requests is None else tuple(requests),
            None if up is None else up.id, next(_IDS), {}))


def span_records(since_ns: Optional[int] = None,
                 until_ns: Optional[int] = None) -> list:
    """The stored spans and counters that start in ``[since_ns,
    until_ns]`` (either end open when None), oldest first."""
    lo = -1 if since_ns is None else since_ns
    hi = float("inf") if until_ns is None else until_ns
    return [r for r in list(_STORE) if lo <= r.start_ns <= hi]


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
