"""Backtrace seconds (`timings["backtrace"]`) per batch, in ms."""


def read(ctx):
    t = ctx.get("timings", {}).get("backtrace")
    if t is None or not ctx.get("batches"):
        return None
    return t * 1e3 / ctx["batches"]
