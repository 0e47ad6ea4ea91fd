"""Share of tracked frames' descent steps, in %, that ran the descent
step's hand-written kernels: the program's ``descent.steps_kernel``
counter over it and ``descent.steps_plain`` together, summed over the
traced window's tracked frames (a batch's steps count once, on every
frame of it), from the program's span store
(``piccolo_tpu_torch.utils.profiling``).  100 where every step of the
window's frames runs the kernel pair, 0 on the autograd step; nothing
where the program counts neither.  Layer: stage 3, the descent
(``tracking.py``, ``solver.py`` over ``kernels/descent_step.py``)."""

import sys

KIND = "tracked"


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
    n = {"descent.steps_kernel": 0, "descent.steps_plain": 0}
    for r in _window(ctx, KIND):
        if r.name in n and r.n is not None:
            n[r.name] += r.n
    total = n["descent.steps_kernel"] + n["descent.steps_plain"]
    if not total:
        return None
    return 100.0 * n["descent.steps_kernel"] / total
