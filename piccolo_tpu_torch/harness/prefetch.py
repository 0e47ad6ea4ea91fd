"""Host/device pipelining for the evaluation loops (a copy of
piccolo_tpu/harness/prefetch.py).

The reference processes queries strictly sequentially — decode, preprocess,
optimize, write artifacts, repeat (reference localize.py:137-297) — so the
GPU idles during every host step.  Device work is dispatched
asynchronously (results are futures until fetched), which makes the natural
shape a two-stage software pipeline:

  * a single background *prepare* thread runs all host-side work for query
    k+1 (image decode, resizes, color harmonization, cloud / grid loading on
    room change) while the device computes query k;
  * a single background *writer* thread encodes and saves image artifacts
    (PNG/GIF) off the critical path.

Both stages preserve order exactly (one thread each, FIFO queues), so every
observable output — CSV rows, RNG consumption, accuracy accounting, skip and
error handling — is identical to the sequential loop; only wall-clock
changes.  ``host_prefetch = False`` in the config falls back to strictly
sequential execution (the prepare callable runs inline).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence, Tuple

__all__ = ["Prefetcher", "AsyncWriter"]

_SENTINEL = object()


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Map ``prepare`` over ``items`` on one background thread, in order.

    Iterating yields ``(item, outcome)`` pairs; pass the outcome through
    :func:`unwrap` *inside* the per-query try block — if ``prepare(item)``
    raised, unwrap re-raises the exception there, exactly where it would
    have surfaced in the sequential loop, so per-query error isolation
    (``continue_on_error``) keeps its semantics.

    ``depth`` bounds how far ahead preparation runs.  The default of 2 keeps
    one query fully staged while the next is being prepared; deeper queues
    only add memory (decoded panoramas are tens of MB each).
    """

    def __init__(
        self,
        items: Sequence,
        prepare: Callable,
        enabled: bool = True,
        depth: int = 2,
    ):
        self._items = list(items)
        self._prepare = prepare
        self._enabled = enabled and len(self._items) > 1
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._thread = None
        self._stop = threading.Event()

    def _put(self, value) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not self._stop.is_set():
            try:
                self._q.put(value, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        for item in self._items:
            if self._stop.is_set():
                return
            try:
                out = self._prepare(item)
            except BaseException as exc:  # delivered at the item's turn
                out = _Failure(exc)
            if not self._put((item, out)):
                return
        self._put(_SENTINEL)

    def close(self) -> None:
        """Release the prepare thread and any staged bundles.

        Called automatically when iteration ends — including when the
        consumer abandons the loop mid-iteration (an uncaught per-query
        exception with ``continue_on_error=False``); without it the prepare
        thread would block forever on the bounded queue, pinning decoded
        panoramas and padded clouds for the life of the process.
        """
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @staticmethod
    def unwrap(outcome):
        """Return the prepared value, re-raising a prepare-time exception."""
        if isinstance(outcome, _Failure):
            raise outcome.exc
        return outcome

    def __iter__(self) -> Iterator[Tuple[object, object]]:
        if not self._enabled:
            for item in self._items:
                try:
                    out = self._prepare(item)
                except BaseException as exc:
                    out = _Failure(exc)
                yield item, out
            return
        self._thread = threading.Thread(
            target=self._run, name="piccolo-prefetch", daemon=True
        )
        self._thread.start()
        try:
            while True:
                got = self._q.get()
                if got is _SENTINEL:
                    break
                yield got
        finally:
            self.close()


class AsyncWriter:
    """Run artifact writes (PNG/GIF encodes) on one background thread.

    ``submit(fn, *args)`` enqueues a call; ``close()`` drains the queue and
    re-raises the first exception any write produced (artifact failures must
    not pass silently, but they need not stall the compute loop either).
    With ``enabled=False`` every submit runs inline.
    """

    def __init__(self, enabled: bool = True):
        self._enabled = enabled
        self._q: "queue.Queue" = queue.Queue()
        self._exc: list = []
        self._thread = None
        if enabled:
            self._thread = threading.Thread(
                target=self._run, name="piccolo-writer", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while True:
            got = self._q.get()
            if got is _SENTINEL:
                return
            fn, args, kwargs = got
            try:
                fn(*args, **kwargs)
            except BaseException as exc:
                if not self._exc:
                    self._exc.append(exc)

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        if not self._enabled:
            fn(*args, **kwargs)
            return
        if self._exc:
            raise self._exc[0]
        self._q.put((fn, args, kwargs))

    def close(self) -> None:
        if self._enabled and self._thread is not None:
            self._q.put(_SENTINEL)
            self._thread.join()
            self._thread = None
        if self._exc:
            raise self._exc[0]

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, *exc_info) -> None:
        # On an in-flight exception still drain pending writes, but don't
        # mask the original error with a writer error.
        try:
            self.close()
        except BaseException:
            if exc_info[0] is None:
                raise
