"""The chain kernel's share of its roofline, in %: the least time of one
frame's chain step over the bucket shapes (`counts.kernels.chain_bytes`)
over the kernel's mean device time per launch in the trace.  Silent when
no chain kernel ran."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    s, n = tr.op_time("chain_group_kernel")
    if not n or s <= 0:
        return None
    return 100.0 * ctx["counts"]["chain_s"] * n / s
