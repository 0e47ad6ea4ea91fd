"""Share of a full query's stage-2 candidates, in %, whose live-splat block
counts came from the splat's hand-written kernel pair: the program's
``stage2.splat_kernel`` counter over it and ``stage2.splat_plain``
together, summed over the traced window's full queries, from the program's
span store (``piccolo_tpu_torch.utils.profiling``).  100 where every
candidate of the window's live splats ran the kernel pair, 0 on the plain
splat; nothing where the program counts neither (a program without the
counters, or a window whose queries all took a HistPlan).  Layer: stage 2,
the histogram trim (``init/refine.py`` over ``kernels/splat_hist.py``)."""

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
    n = {"stage2.splat_kernel": 0, "stage2.splat_plain": 0}
    for r in _window(ctx, KIND):
        if r.name in n and r.n is not None:
            n[r.name] += r.n
    total = n["stage2.splat_kernel"] + n["stage2.splat_plain"]
    if not total:
        return None
    return 100.0 * n["stage2.splat_kernel"] / total
