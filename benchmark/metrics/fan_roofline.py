"""The fan kernel's share of its roofline, in %: its least time per
launch (`counts.kernels.fan_bytes` at the memory rate, or its operations
at the float32 rate, whichever is longer) over its mean device time per
launch in the trace.  Silent when no fan kernel ran."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    s, n = tr.op_time("fan_kernel")
    if not n or s <= 0:
        return None
    return 100.0 * ctx["counts"]["fan_s"] * n / s
