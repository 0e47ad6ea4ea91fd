"""Mean milliseconds a tracked frame waits in the service's ``track_batch``
queue, the program's ``track.queue_wait`` record (from the frame's
queueing to the start of the batch that answers it, on whichever thread
runs that batch), over the traced window's tracked frames, from the
program's span store (``piccolo_tpu_torch.utils.profiling``).  Layer:
tracking (the service's track path)."""

import sys

KIND, SPAN = "tracked", "track.queue_wait"


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
