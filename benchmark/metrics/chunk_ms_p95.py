"""The 95th percentile over every chunk of the traced window of the wait
a live client has for it: `process_raw`, plus `partial_hyp` where due,
on the host's clock, in ms."""

import numpy as np


def read(ctx):
    xs = ctx.get("chunk_seconds")
    return float(np.percentile(xs, 95)) * 1e3 if xs else None
