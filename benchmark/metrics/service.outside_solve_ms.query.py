"""Mean milliseconds a full query spends in the service outside its solve:
the reply's ``total_s`` (from admission, including the wait for the
compute lock) less its ``time_s`` (the solve under the lock), over the
traced window's full queries.  Layer: service (``serve.py``)."""


def read(ctx):
    v = [r["total_s"] - r["time_s"] for r in ctx["records"]
         if not r["tracked"] and "error" not in r]
    return 1e3 * sum(v) / len(v) if v else None
