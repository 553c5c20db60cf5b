"""The median over the traced window's utterances of `end_utt` through
`hyp` and `seg` (the flush block, the backtrace, the lattice and best
path), on the host's clock, in ms."""

import statistics


def read(ctx):
    xs = ctx.get("end_seconds")
    return statistics.median(xs) * 1e3 if xs else None
