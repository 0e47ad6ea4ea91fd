"""The descent's share of its roofline, in %: the least time the
multi-start descent's work needs (``roofline.descent``: every start's
steps over every point) over its device time a query."""

SPAN = "localize.stage3_descent"


def read(ctx):
    tr, sh, rf = ctx["trace"], ctx["shapes"], ctx["roofline"]
    n = tr.get("spans", {}).get(SPAN, 0)
    s = tr.get("by_stage", {}).get(SPAN)
    if not n or not s:
        return None
    least = rf.descent(sh["starts"], sh["iterations"], sh["points"],
                       sh["main_hw"])
    return 100.0 * least / (s / n)
