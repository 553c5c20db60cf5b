"""The share of the scan's lane-frames that stepped padding, in %:
100 x (1 - "scan.real_frames" / "scan.lane_frames"), the program's
counters (each batch's utterance frames, and its batch size x its frames
padded to whole chunks), over the run: the warm call and the window,
whose calls all hold the same lengths."""

from benchmark.counts.program import program_counters


def read(ctx):
    c = program_counters()
    if not c or not c.get("scan.lane_frames"):
        return None
    return 100.0 * (1.0 - c["scan.real_frames"] / c["scan.lane_frames"])
