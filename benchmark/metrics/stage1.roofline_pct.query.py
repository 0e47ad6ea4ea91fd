"""Stage 1's share of its roofline, in %: the least time the loss table's
work needs on the card (``roofline.stage1``: every pair's loss over every
point, from the cell's shapes) over its device time a query."""

SPAN = "localize.stage1_loss_table"


def read(ctx):
    tr, sh, rf = ctx["trace"], ctx["shapes"], ctx["roofline"]
    n = tr.get("spans", {}).get(SPAN, 0)
    s = tr.get("by_stage", {}).get(SPAN)
    if not n or not s:
        return None
    return 100.0 * rf.stage1(sh["pairs"], sh["points"], sh["init_hw"]) / (s / n)
