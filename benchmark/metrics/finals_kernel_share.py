"""The share of the scan's frames (padded to whole chunks) whose
word-final block the fan step stepped (the fan kernel on the card), in
%: 100 x
"scan.finals_kernel" / ("scan.finals_kernel" + "scan.finals_plain"),
the program's counters over the run.  The rest went through the scan's
torch finals block (`_finals_step`), kept for the topologies the kernel
is not built for.  Silent where the program keeps neither counter."""

from benchmark.counts.program import program_counters


def read(ctx):
    c = program_counters() or {}
    k, p = c.get("scan.finals_kernel", 0), c.get("scan.finals_plain", 0)
    if not k + p:
        return None
    return 100.0 * k / (k + p)
