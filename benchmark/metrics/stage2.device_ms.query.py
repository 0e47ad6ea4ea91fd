"""Device milliseconds a full query spends inside the program's
``localize.stage2_hist_trim`` span: the traced window's device time charged to the span,
over the spans opened in the window."""

SPAN = "localize.stage2_hist_trim"


def read(ctx):
    tr = ctx["trace"]
    n = tr.get("spans", {}).get(SPAN, 0)
    s = tr.get("by_stage", {}).get(SPAN)
    return 1e3 * s / n if n and s else None
