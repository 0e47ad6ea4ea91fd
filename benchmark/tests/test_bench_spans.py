"""The traced runs read the program's spans and counters: small CPU runs of
both cells print the per-layer metrics that read the program's span store,
finite, and each reader keeps to its own window when the store also holds
an earlier traced run of the same process."""

from __future__ import annotations

import math

from benchmark import spec as spec_mod
from benchmark.tests import tiny

QUERY = ("service.prep_ms.query", "service.lock_wait_ms.query",
         "stage1.planned_pct.query")
TRACK = ("track.prep_ms.track", "track.queue_wait_ms.track")
DESCENT = "track.descent_device_ms.track"


def _store_window(ctx):
    """The store's records between the window's first request sent and
    its last reply."""
    from piccolo_tpu_torch.utils import profiling

    recs = ctx["records"]
    return profiling.span_records(
        int(min(r["t_issue"] for r in recs) * 1e9),
        int(max(r["t_done"] for r in recs) * 1e9))


def test_traced_runs_read_the_spans(tmp_path, monkeypatch):
    root = tiny.make(tmp_path)
    bench = root / "benchmark"
    ctxs = []
    reader = spec_mod.reader

    def keeping(metric, here=spec_mod.HERE):
        read = reader(metric, here)

        def keep(ctx):
            if not ctxs or ctxs[-1] is not ctx:
                ctxs.append(ctx)
            return read(ctx)
        return keep

    monkeypatch.setattr(spec_mod, "reader", keeping)
    query = tiny.run(root, "omniscenes.query", 2147483650, trace=True)
    track = tiny.run(root, "omniscenes.track", 3000000019, trace=True)
    ctx_q, ctx_t = ctxs
    for res, names in ((query, QUERY), (track, TRACK)):
        for name in names:
            assert math.isfinite(res["metrics"][name]["value"]), name
    # the CPU traces no device op, so the descent's device time reads
    # nothing here; the window opened one descent span a batch, and the
    # reader divides what the trace charges by the frames answered
    assert DESCENT not in track["metrics"]
    batches = [r for r in _store_window(ctx_t) if r.name == "track.batch"]
    assert batches
    assert ctx_t["trace"]["spans"]["localize.stage3_descent"] == len(batches)
    frames = sum(1 for r in ctx_t["records"] if r["tracked"])
    charged = dict(ctx_t, trace=dict(ctx_t["trace"], by_stage={
        "localize.stage3_descent": 0.5}))
    assert reader(DESCENT, bench)(charged) == 500.0 / frames

    # the store now holds both runs: each window reads its own requests
    for name in QUERY:
        assert reader(name, bench)(ctx_q) == query["metrics"][name]["value"]
        assert reader(name, bench)(ctx_t) is None
    for name in TRACK:
        assert reader(name, bench)(ctx_t) == track["metrics"][name]["value"]
        assert reader(name, bench)(ctx_q) is None
