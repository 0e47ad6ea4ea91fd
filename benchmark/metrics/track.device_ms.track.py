"""Device milliseconds a tracked frame costs: the traced window's device
busy time (mean over cards) over the tracked frames answered in it.  The
program has no span around a tracked frame yet."""


def read(ctx):
    n = sum(1 for r in ctx["records"] if r["tracked"] and "error" not in r)
    busy = ctx["trace"].get("busy_s")
    return 1e3 * busy / n if n and busy else None
