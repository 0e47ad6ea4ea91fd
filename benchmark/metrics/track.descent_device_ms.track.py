"""Device milliseconds a tracked frame's descent costs: the traced window's
device time charged to the program's ``localize.stage3_descent`` span
(the frame's table build and its descent, one span a batch) over the
tracked frames answered in the window.  Layer: tracking (``tracking.py``
under the service's ``track_batch``)."""

SPAN = "localize.stage3_descent"


def read(ctx):
    n = sum(1 for r in ctx["records"] if r["tracked"] and "error" not in r)
    s = ctx["trace"].get("by_stage", {}).get(SPAN)
    return 1e3 * s / n if n and s else None
