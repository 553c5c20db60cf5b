"""The host's CUDA API calls that put work on a stream (kernels, graph
launches, copies, fills: `trace.LAUNCH_APIS`) over the padded batch
frames of the traced window."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("batch_frames"):
        return None
    return tr.host_launches / ctx["batch_frames"]
