"""The traced window: one ``torch.profiler`` session and what is read from it.

Copied and frozen from the program's tools: the profiler session opens
with 256 one-element kernels on each card, after which every card is
synchronised (``piccolo_tpu_torch/utils/profiling.py``'s ``maybe_trace``
warm-up: a session in a process that has run for a while loses its first
device records, and the warm-up kernels take that loss); each device
operation is charged to the innermost ``localize.*`` span around the torch
op or the runtime call that launched it, and the port's own kernels,
launched through ctypes, by name where no span is found
(``chip_smoke.py``'s ``cpu_op_stages`` and ``profile_query``).

Busy time is the union of device operations' intervals on each card,
inside the window (the ``bench.window`` span on the driving thread); the
idle share is the rest of the window.  ``breakdown`` lists the device
operations that took most time and the longest idle gaps, each labelled by
the innermost host operations that were running at the gap's middle.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

WARMUP_KERNELS = 256
WINDOW_SPAN = "bench.window"
STAGES = ("localize.stage1_loss_table", "localize.stage2_hist_trim",
          "localize.stage3_descent")
OWN_KERNELS = {"slab_sums_kernel": "localize.stage1_loss_table",
               "block_histogram_kernel": "localize.stage2_hist_trim"}


@contextlib.contextmanager
def session(cards: int):
    """A profiler over CPU and CUDA, recording every thread where the
    installed PyTorch can; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    for i in range(cards):
        torch.cuda.synchronize(i)
    with profile(activities=acts, **kw) as prof:
        with torch.profiler.record_function("bench.trace_warmup"):
            for i in range(cards):
                x = torch.zeros(1, device=torch.device("cuda", i))
                for _ in range(WARMUP_KERNELS):
                    x.add_(1)
        for i in range(cards):
            torch.cuda.synchronize(i)
        yield prof
        for i in range(cards):
            torch.cuda.synchronize(i)


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _gaps(intervals, lo, hi):
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def read(prof, cards: int) -> Dict:
    """Busy and window seconds, device seconds and span counts by stage,
    and the breakdown, from a finished session.

    A device operation belongs to the stage span that was open when the
    host launched it: the runtime call that shares its correlation id is
    placed inside the spans by time, on its own thread where a span of
    that thread encloses it, else in the one span that encloses it on any
    thread (the stages of one card run under its compute lock, one at a
    time).  Failing that, the torch op that made the launch, then the
    port's own kernels by name."""
    import bisect

    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    cpu = [e for e in raw if e.device_type() == DeviceType.CPU]
    win = [e for e in cpu if e.name() == WINDOW_SPAN]
    if not win:
        return {}
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    spans = sorted((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
                   for e in cpu if e.name() in STAGES)
    starts = [sp[0] for sp in spans]
    count = {s: 0 for s in STAGES}
    for sp in spans:
        if w0 <= sp[0] <= w1:
            count[sp[2]] += 1

    def enclosing(t, tid):
        i = bisect.bisect_right(starts, t)
        hits = [sp for sp in spans[max(0, i - 16):i] if sp[1] >= t]
        same = [sp for sp in hits if sp[3] == tid]
        if same:
            return same[-1][2]
        return hits[0][2] if len(hits) == 1 else None

    call_stage, op_stage = {}, {}
    threads: Dict[int, list] = {}
    for e in cpu:
        name = e.name()
        if e.linked_correlation_id() != 0 or name.startswith("cu"):
            call_stage[e.correlation_id()] = enclosing(e.start_ns(),
                                                       e.start_thread_id())
        else:
            threads.setdefault(e.start_thread_id(), []).append(e)
    for evs in threads.values():
        evs.sort(key=lambda e: (e.start_ns(), -e.end_ns()))
        stack = []
        for e in evs:
            while stack and stack[-1][0] <= e.start_ns():
                stack.pop()
            up = stack[-1][1] if stack else None
            stage = e.name() if e.name() in count else up
            op_stage[e.correlation_id()] = stage
            stack.append((e.end_ns(), stage))
    by_card: Dict[int, list] = {}
    by_stage: Dict[str, float] = {}
    by_op: Dict[str, float] = {}
    how = {"launch": 0, "op": 0, "name": 0, "none": 0}
    for e in raw:
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        if name.startswith("localize.") or name.startswith("bench."):
            continue
        s, d = e.start_ns(), e.duration_ns()
        if s < w0 or s > w1:
            continue
        by_card.setdefault(e.device_index(), []).append((s, s + d))
        by_op[name] = by_op.get(name, 0.0) + d / 1e9
        stage, rule = call_stage.get(e.correlation_id()), "launch"
        if stage is None:
            stage, rule = op_stage.get(e.linked_correlation_id()), "op"
        if stage is None:
            stage, rule = next((v for k, v in OWN_KERNELS.items()
                                if k in name), None), "name"
        if stage in count:
            by_stage[stage] = by_stage.get(stage, 0.0) + d / 1e9
            how[rule] += 1
        else:
            how["none"] += 1
    window_s = (w1 - w0) / 1e9
    busy = [_union(v) / 1e9 for v in by_card.values()]
    busy_s = sum(busy) / max(cards, 1)
    gaps = []
    for iv in by_card.values():
        gaps += _gaps(iv, w0, w1)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = [[_host_at(cpu, (a + b) // 2), (b - a) / 1e9]
                for a, b in gaps[:10]]
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy_s, window_s=window_s, by_stage=by_stage,
                spans=count, attributed=how,
                device_ops=[[k[:120], v] for k, v in top_ops],
                idle_gaps=labelled)


def _host_at(cpu: List, t_ns: int) -> str:
    """The innermost host operations running at ``t_ns`` on each thread."""
    inner: Dict[int, tuple] = {}
    for e in cpu:
        if (e.start_ns() <= t_ns <= e.end_ns() and e.name() != WINDOW_SPAN
                and not e.name().startswith("cuda")):
            tid = e.start_thread_id()
            if tid not in inner or e.start_ns() >= inner[tid][0]:
                inner[tid] = (e.start_ns(), e.name())
    names = sorted({v[1] for v in inner.values()})
    return (" | ".join(names) or "no host op recorded")[:160]
