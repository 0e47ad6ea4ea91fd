"""Share of the traced window, in %, in which no operation ran on the
card (mean over the cards used)."""


def read(ctx):
    tr = ctx["trace"]
    busy, window = tr.get("busy_s"), tr.get("window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
