"""Scan seconds (`timings["scan"]`) per padded batch frame, in ms."""


def read(ctx):
    t = ctx.get("timings", {}).get("scan")
    if t is None or not ctx.get("batch_frames"):
        return None
    return t * 1e3 / ctx["batch_frames"]
