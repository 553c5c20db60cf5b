"""The seconds the program spent capturing CUDA graphs, without the
kernels' builds inside them: its counter "capture_s" over the run (the
warm call's captures, and any in the window).  0 where nothing was
captured (on the CPU)."""

from benchmark.counts.program import program_counters


def read(ctx):
    c = program_counters()
    if c is None:
        return None
    return float(c.get("capture_s", 0.0))
