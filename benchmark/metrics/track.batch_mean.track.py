"""Mean batch a tracked frame was answered in (the reply's ``batched``,
1 when alone), over the traced window's tracked frames."""


def read(ctx):
    v = [r["batched"] for r in ctx["records"]
         if r["tracked"] and "error" not in r]
    return sum(v) / len(v) if v else None
