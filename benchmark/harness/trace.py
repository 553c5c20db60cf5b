"""The profiler's trace of a window, reduced to what the per-layer
metrics read: the device's busy time (the union of its intervals), the
time and count of each device operation by name, the host's launches,
and the longest idle gaps named by what the host was doing.

It reads the raw events (`kineto_results.events()`): building the
profiler's own event lists takes minutes over the hundreds of thousands
of kernels a window of graph replays holds."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

#: the host span around the traced window
MARK = "bench.window"
#: the CUDA API calls that put work on a stream (a frozen copy of
#: `chip_smoke.LAUNCH_APIS`, commit 877b0e812f03b9328e7049cc92b93a2d85380b01)
LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
               "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
               "cuMemcpyAsync", "cuMemsetD")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    #: device operation name -> [seconds, count]
    ops: dict = field(default_factory=dict)
    host_launches: int = 0
    #: the longest idle gaps, (what the host was doing, seconds)
    idle_gaps: list = field(default_factory=list)

    def op_time(self, key: str):
        """(seconds, count) of the device operations whose name holds
        `key`; (0.0, 0) when none ran."""
        s = c = 0
        for name, (t, n) in self.ops.items():
            if key in name:
                s += t
                c += n
        return s, c

    def top_ops(self, n: int = 10):
        return sorted(([k, v[0]] for k, v in self.ops.items()),
                      key=lambda r: -r[1])[:n]


def reduce_events(events, t0_ns: int, t1_ns: int, n_gaps: int = 10,
                  is_device=None, chips: int = 1) -> Trace:
    """`events`: raw profiler events (name(), device_type(), start_ns(),
    duration_ns(), device_index()) of a window [t0_ns, t1_ns] on the
    host's clock.  The busy time is each card's union of intervals,
    averaged over the `chips` cards the run uses; the idle gaps are
    where no card was busy."""
    if is_device is None:
        from torch.autograd import DeviceType
        is_device = lambda e: e.device_type() == DeviceType.CUDA  # noqa
    dev, host, per_card = [], [], {}
    ops = {}
    launches = 0
    for e in events:
        name = e.name()
        s = e.start_ns()
        d = e.duration_ns()
        if is_device(e):
            if name == MARK or e.is_user_annotation():
                continue          # the window's own span, not device work
            dev.append((s, s + d))
            per_card.setdefault(e.device_index(), []).append((s, s + d))
            r = ops.setdefault(name, [0.0, 0])
            r[0] += d * 1e-9
            r[1] += 1
        elif name.startswith(LAUNCH_APIS):
            launches += 1
        elif name != MARK and not name.startswith(("cuda", "cu")) \
                and d > 0:
            host.append((s, s + d, name))
    _, gaps = _union(dev, t0_ns, t1_ns)
    busy = sum(_union(iv, t0_ns, t1_ns)[0] for iv in per_card.values()
               ) / max(chips, 1)
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    named = [[_host_at(host, (a + b) // 2), (b - a) * 1e-9]
             for a, b in gaps[:n_gaps]]
    return Trace(window_s=(t1_ns - t0_ns) * 1e-9, busy_s=busy * 1e-9,
                 ops=ops, host_launches=launches, idle_gaps=named)


def _union(intervals, t0, t1):
    """(covered ns of [t0, t1], the gaps between covered stretches)."""
    busy = 0
    gaps = []
    at = t0
    for s, e in sorted(intervals):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
            at = s
        if e > at:
            busy += e - at
            at = e
    if at < t1:
        gaps.append((at, t1))
    return busy, gaps


def _host_at(host, t):
    """The innermost host operation running at time `t` (the one that
    started last), or "host (no operation)"."""
    best = None
    for s, e, name in host:
        if s <= t < e and (best is None or s > best[0]):
            best = (s, name)
    return best[1] if best else "host (no operation)"


@contextlib.contextmanager
def traced(enabled: bool, device, chips: int = 1):
    """Profile the block (the host's activity, and the cards' on CUDA)
    when `enabled`; yields a dict that receives "trace" (a `Trace` over
    `chips` cards) once the block has ended."""
    out = {}
    if not enabled:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def sync():
        for i in range(chips if cuda else 0):
            torch.cuda.synchronize(i)

    with profile(activities=acts) as prof:
        sync()
        with torch.profiler.record_function(MARK):
            yield out
            sync()
    events = prof.profiler.kineto_results.events()
    mark = [e for e in events if e.name() == MARK]
    t0 = mark[0].start_ns()
    out["trace"] = reduce_events(events, t0, t0 + mark[0].duration_ns(),
                                 chips=chips)
