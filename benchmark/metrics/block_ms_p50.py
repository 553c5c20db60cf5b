"""The median of `Decoder.stream_block_seconds` (scoring, scan and the
records' copy to the host of one 32-frame stream block, synced), in
ms."""

import statistics


def read(ctx):
    xs = ctx.get("block_seconds")
    return statistics.median(xs) * 1e3 if xs else None
