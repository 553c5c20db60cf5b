"""The blocking reads of its own results the program makes per batch
(one data row's part of a batch): its counters "host_syncs" over
"scan.batches", over the run (the warm call and the window).  A batch
reads its frame counts, each segment step of the backtrace's walk and
the one that ends it, and five outputs of the backtrace."""

from benchmark.counts.program import program_counters


def read(ctx):
    c = program_counters()
    if not c or not c.get("scan.batches"):
        return None
    return c.get("host_syncs", 0) / c["scan.batches"]
