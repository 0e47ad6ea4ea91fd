"""Mean milliseconds a full query waits for its card's compute lock, the
program's ``service.lock_wait`` span (from asking for the lock to holding
it), over the traced window's full queries, from the program's span store
(``piccolo_tpu_torch.utils.profiling``).  Layer: service (``serve.py``)."""

import sys

KIND, SPAN = "query", "service.lock_wait"


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
    v = [r.end_ns - r.start_ns for r in _window(ctx, KIND) if r.name == SPAN]
    return sum(v) / len(v) / 1e6 if v else None
