"""Share of stage 1's real pairs, in %, that a slab plan scored: the
program's ``stage1.pairs_planned`` counter over its ``stage1.pairs``,
summed over the traced window's full queries, from the program's span
store (``piccolo_tpu_torch.utils.profiling``).  100 on a whole plan, less
on a partial one, 0 on the gather engine.  Layer: stage 1, the loss
table (``harness/localize.py::_run_fused``)."""

import sys

KIND = "query"


def _window(ctx, kind):
    """The store's records that belong to the window's requests of
    ``kind``: those whose ``service.request`` span starts between the
    window's first request sent and its last reply, on the host's clock;
    [] when the program keeps no store."""
    store = sys.modules.get("piccolo_tpu_torch.utils.profiling")
    span_records = getattr(store, "span_records", None)
    recs = ctx["records"]
    if span_records is None or not recs:
        return []
    lo = int(min(r["t_issue"] for r in recs) * 1e9)
    hi = int(max(r["t_done"] for r in recs) * 1e9)
    window = span_records(lo, hi)
    ids = {r.requests[0] for r in window if r.name == "service.request"
           and r.requests and r.attrs.get("kind") == kind}
    return [r for r in window if ids.intersection(r.requests)]


def read(ctx):
    n = {"stage1.pairs": 0, "stage1.pairs_planned": 0}
    for r in _window(ctx, KIND):
        if r.name in n and r.n is not None:
            n[r.name] += r.n
    if not n["stage1.pairs"]:
        return None
    return 100.0 * n["stage1.pairs_planned"] / n["stage1.pairs"]
