"""Stage 2's share of its roofline, in %: the least time the histogram
trim's work needs (``roofline.stage2``: a splat and block histograms for
each candidate) over its device time a query."""

SPAN = "localize.stage2_hist_trim"


def read(ctx):
    tr, sh, rf = ctx["trace"], ctx["shapes"], ctx["roofline"]
    n = tr.get("spans", {}).get(SPAN, 0)
    s = tr.get("by_stage", {}).get(SPAN)
    if not n or not s:
        return None
    least = rf.stage2(sh["candidates"], sh["points"], sh["init_hw"],
                      sh["blocks"])
    return 100.0 * least / (s / n)
