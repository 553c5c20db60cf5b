"""The whole step's share of the card's peaks, in %: the least time of
one batch-frame step (the scoring's operations at the float32 rate plus
the fan's, chain's and transitions' bytes at the memory rate:
`counts.kernels.step_counts`) over the traced window's wall time per
padded batch frame (frontend through backtrace), averaged over the
cards of the mesh (a batch frame is one data row's part of a batch)."""


def read(ctx):
    if ctx.get("trace") is None or not ctx.get("batch_frames"):
        return None
    wall = ctx["window_s"] / ctx["batch_frames"]
    return 100.0 * ctx["counts"]["step_s"] / wall / ctx.get("chips", 1)
