"""The descent graphs' cache in ``piccolo_tpu_torch.solver``, on the CPU.

A capture needs a card, so a stand-in graph class takes the place of
``_StepGraph`` here: it records its key and reports fixed pool and static
bytes.  What is held is the cache around it: misses on one key capture
once while hits on other keys go on, the LRU evicts by bytes against
``GRAPH_MEM_FRACTION`` of the card's memory, evictions and recaptures are
counted, and a failed capture leaves the key free for the next call.
"""

import sys
import threading
import time
import types
from collections import OrderedDict

import pytest
import torch

from piccolo_tpu_torch import solver
from piccolo_tpu_torch.loss import Pose
from piccolo_tpu_torch.optim import init_adam_plateau

torch.set_num_threads(1)

TOTAL = 16_000  # the stand-in card's memory: a cap of 1,000 bytes


class FakeGraph:
    """Stands in for ``solver._StepGraph``: 300 bytes a graph."""

    started = None  # an Event set when a capture begins
    release = None  # an Event a capture waits for
    fail = False
    delay = 0.0  # seconds a capture takes
    made = []

    def __init__(self, key, x, s, params, state):
        cls = type(self)
        if cls.started is not None:
            cls.started.set()
        if cls.release is not None:
            assert cls.release.wait(30)
        time.sleep(cls.delay)
        if cls.fail:
            raise RuntimeError("capture failed")
        self.key, self.pool_bytes, self.static_bytes = key, 200, 100
        cls.made.append(key)

    def stats(self):
        return dict(key=self.key)


@pytest.fixture
def cache(monkeypatch):
    monkeypatch.setattr(solver, "_GRAPHS", OrderedDict())
    monkeypatch.setattr(solver, "_PENDING", {})
    monkeypatch.setattr(solver, "_COUNTS",
                        dict(captures=0, evictions=0, recaptures=0))
    monkeypatch.setattr(solver, "_EVICTED", set())
    monkeypatch.setattr(solver, "_StepGraph", FakeGraph)
    monkeypatch.setattr(solver, "GRAPH_MEM_FRACTION", 1 / 16)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=TOTAL))
    monkeypatch.setattr(FakeGraph, "made", [])
    monkeypatch.setattr(FakeGraph, "started", None)
    monkeypatch.setattr(FakeGraph, "release", None)
    monkeypatch.setattr(FakeGraph, "fail", False)
    monkeypatch.setattr(FakeGraph, "delay", 0.0)
    return solver


def _args(starts):
    """Inputs whose key differs by the number of starts."""
    x = solver.StepInputs(torch.zeros(8, 12), torch.zeros(10, 3),
                          torch.zeros(10, 3), None, torch.zeros(3),
                          torch.ones(3), None)
    s = solver.StepStatics(4, 8, 5, 0.8, False)
    params = Pose(t=torch.zeros(starts, 3), yaw=torch.zeros(starts),
                  pitch=torch.zeros(starts), roll=torch.zeros(starts))
    return x, s, params, init_adam_plateau(params, 0.1)


def test_misses_on_one_key_capture_once_and_hits_go_on(cache):
    """Four calls missing one key wait for its one capture; meanwhile a
    call on a key already cached returns at once."""
    hit = cache._graph_for(*_args(2))
    FakeGraph.started, FakeGraph.release = threading.Event(), threading.Event()
    got = [None] * 4

    def go(i):
        got[i] = cache._graph_for(*_args(6))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    assert FakeGraph.started.wait(30)
    assert cache._graph_for(*_args(2)) is hit  # not held by the capture
    FakeGraph.release.set()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads)
    assert all(g is got[0] for g in got) and got[0] is not hit
    assert cache.graph_stats()["captures"] == 2 and len(FakeGraph.made) == 2
    assert not cache._PENDING


def test_many_threads_on_few_keys_capture_each_once(cache):
    """32 threads over 3 keys (all fit the cap), captures of 5 ms, with the
    interpreter switching threads every microsecond: each key is captured
    once and every thread on a key gets that key's one graph."""
    FakeGraph.delay = 0.005
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, gate = {}, threading.Barrier(32)

        def go(i):
            gate.wait()
            got[i] = cache._graph_for(*_args(1 + i % 3))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and len(got) == 32
    for i in range(32):
        assert got[i] is got[i % 3]
    assert cache.graph_stats()["captures"] == 3 and not cache._PENDING


def test_lru_evicts_by_bytes_and_counts_recaptures(cache):
    """Three graphs of 300 bytes fit a 1,000-byte cap, a fourth evicts the
    least recently used (a hit refreshes a graph); capturing an evicted
    key again counts as a recapture."""
    for n in (1, 2, 3):
        cache._graph_for(*_args(n))
    cache._graph_for(*_args(1))  # a hit: 2 is now the oldest
    cache._graph_for(*_args(4))
    keys = [k[3][0][0][0] for k in cache._GRAPHS]  # starts of each key
    assert keys == [3, 1, 4]
    stats = cache.graph_stats()
    assert (stats["captures"], stats["evictions"], stats["recaptures"]) == (
        4, 1, 0)
    cache._graph_for(*_args(2))
    stats = cache.graph_stats()
    assert (stats["captures"], stats["evictions"], stats["recaptures"]) == (
        5, 2, 1)
    assert [k[3][0][0][0] for k in cache._GRAPHS] == [1, 4, 2]


def test_the_newest_graph_stays_over_the_cap(cache, monkeypatch):
    """A graph larger than the cap evicts every other graph of its device
    and stays."""
    monkeypatch.setattr(cache, "GRAPH_MEM_FRACTION", 0.0)
    cache._graph_for(*_args(1))
    g = cache._graph_for(*_args(2))
    assert list(cache._GRAPHS.values()) == [g]
    assert cache.graph_stats()["evictions"] == 1


def test_a_failed_capture_raises_and_frees_its_key(cache):
    """A capture that fails raises to its caller and caches nothing; the
    next call on the key captures it."""
    FakeGraph.fail = True
    with pytest.raises(RuntimeError, match="capture failed"):
        cache._graph_for(*_args(3))
    assert not cache._GRAPHS and not cache._PENDING
    FakeGraph.fail = False
    g = cache._graph_for(*_args(3))
    assert cache._graph_for(*_args(3)) is g
    assert cache.graph_stats()["captures"] == 1


def test_graph_stats_lists_graphs_and_counts(cache):
    """graph_stats() gives the cached graphs and the three counters."""
    assert cache.graph_stats() == dict(graphs=[], captures=0, evictions=0,
                                       recaptures=0)
