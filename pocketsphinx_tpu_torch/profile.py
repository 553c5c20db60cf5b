"""Timers, xRT reporting, and the batch path's spans and counters.

Port of `pocketsphinx_tpu.profile`.  A `Timer` given a CUDA device
synchronizes it before it stops, so a stage's seconds include the
device work the stage queued (the JAX stages end on a host read, which
waits for the device in the same way).

Re-design of the reference's profiling subsystem:
  * `Timer` = `ptmr_t` (src/util/profile.c:93-128): accumulating
    CPU + wall timers with start/stop/reset;
  * `log_xrt` mirrors the per-pass E_INFO lines
    ("fwdtree 0.12 CPU 0.043 xRT", src/ngram_search.c:866-871).

The decoder facade keeps one utterance Timer (reset per utterance) and
accumulating totals, exposed as `get_utt_time` / `get_all_time` exactly
like ps_get_utt_time/ps_get_all_time (include/pocketsphinx.h:1079-1093),
plus named stage timers (frontend / score+search / backtrace /
bestpath).

The corpus path (`BatchDecodePipeline.decode_corpus` and the searches'
`decode_batch`) marks its stages with `span` (names start with "ps.")
and counts its work with `count`:

  * a span is a `torch.profiler.record_function` while a profiler
    records in the calling thread, so a trace names every stretch of
    host time by the stage that spent it; given a `timings` dict it
    also synchronizes the device at both ends and adds the stage's wall
    seconds under its key (the stage timers of `decode_corpus(timings=)`);
    otherwise it costs one flag test;
  * the counters are process-wide totals, always on, read with
    `counters()`: "scan.batches", "scan.lane_frames" (batch x frames
    padded to whole chunks, what the scan steps), "scan.real_frames"
    (the utterances' frames), "host_syncs" (the blocking reads of the
    search's own results) and "capture_s" (the seconds of CUDA-graph
    captures, without kernel builds).  They are counted per batch,
    chunk or capture, never per frame.

    with torch.profiler.profile() as prof:
        pipe.decode_corpus(pcms)
    prof.key_averages()                      # the "ps." spans' times
    profile.counters()["host_syncs"]
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import torch

_lock = threading.Lock()
_counts: dict = {}
_NO_SPAN = contextlib.nullcontext()


def count(name: str, n=1):
    """Add `n` to the process-wide counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter's total in this process."""
    with _lock:
        return dict(_counts)


def span(name: str, timings: dict | None = None, key: str | None = None,
         device=None):
    """A context manager marking one stage `name`: a profiler span when
    a `torch.profiler` records in this thread, and with a `timings` dict
    the stage's wall seconds added to `timings[key]`, `device` (a CUDA
    one) synchronized at both ends so that they hold the device work
    the stage queued.  Without either it does nothing."""
    if timings is None and not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return _span(name, timings, key, device)


@contextlib.contextmanager
def _span(name, timings, key, device):
    rec = (torch.profiler.record_function(name)
           if torch.autograd._profiler_enabled() else _NO_SPAN)
    with rec:
        if timings is None:
            yield
            return
        t0 = _wall(device)
        yield
        timings[key] = timings.get(key, 0.0) + _wall(device) - t0


def _wall(device):
    """The wall clock, after `device`'s queued work on a CUDA device."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class Timer:
    """Accumulating CPU + wall timer (ptmr_t).  With a CUDA `device`,
    `stop` first waits for the device's queued work."""

    def __init__(self, name: str = "", device=None):
        self.name = name
        self.device = device
        self.reset()

    def reset(self):
        self.t_cpu = 0.0
        self.t_elapsed = 0.0
        self._c0 = None
        self._w0 = None

    def start(self):
        self._c0 = time.process_time()
        self._w0 = time.perf_counter()

    def stop(self):
        if self._w0 is None:
            return
        w1 = _wall(self.device)
        self.t_cpu += time.process_time() - self._c0
        self.t_elapsed += w1 - self._w0
        self._c0 = self._w0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


def log_xrt(name: str, timer: Timer, n_speech: float,
            stream=None, loglevel: str = "INFO"):
    """Reference-style per-pass xRT lines (src/ngram_search.c:866-871),
    routed through the err subsystem (logfn/callback redirection)
    unless an explicit stream is given."""
    if loglevel not in ("INFO", "DEBUG"):
        return
    if n_speech <= 0:
        return
    l1 = (f"{name} {timer.t_cpu:.2f} CPU "
          f"{timer.t_cpu / n_speech:.3f} xRT")
    l2 = (f"{name} {timer.t_elapsed:.2f} wall "
          f"{timer.t_elapsed / n_speech:.3f} xRT")
    if stream is not None:
        stream.write(f"INFO: {l1}\nINFO: {l2}\n")
        return
    from . import err
    err.E_INFO(l1)
    err.E_INFO(l2)


@dataclass
class PerfReport:
    """Aggregated decoder performance (ps_get_all_time semantics)."""

    n_speech: float = 0.0
    t_cpu: float = 0.0
    t_elapsed: float = 0.0
    stages: dict = field(default_factory=dict)

    def add(self, n_speech: float, timer: Timer, stage_timers=()):
        self.n_speech += n_speech
        self.t_cpu += timer.t_cpu
        self.t_elapsed += timer.t_elapsed
        for st in stage_timers:
            acc = self.stages.setdefault(st.name, [0.0, 0.0])
            acc[0] += st.t_cpu
            acc[1] += st.t_elapsed
