"""Timers, xRT reporting, and per-pass statistics.

Port of `pocketsphinx_tpu.profile`.  A `Timer` given a CUDA device
synchronizes it before it stops, so a stage's seconds include the
device work the stage queued (the JAX stages end on a host read, which
waits for the device in the same way).

Re-design of the reference's profiling subsystem:
  * `Timer` = `ptmr_t` (src/util/profile.c:93-128): accumulating
    CPU + wall timers with start/stop/reset;
  * `DecodeStats` = `ngram_search_stats_t` (src/ngram_search.h:183-194)
    counters, dense-search flavored (everything is evaluated every
    frame, so the counters are exact products rather than pruned
    tallies);
  * `log_xrt` mirrors the per-pass E_INFO lines
    ("fwdtree 0.12 CPU 0.043 xRT", src/ngram_search.c:866-871).

The decoder facade keeps one utterance Timer (reset per utterance) and
accumulating totals, exposed as `get_utt_time` / `get_all_time` exactly
like ps_get_utt_time/ps_get_all_time (include/pocketsphinx.h:1079-1093),
plus named stage timers (frontend / score+search / backtrace /
bestpath).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


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
        if self.device is not None and self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        self.t_cpu += time.process_time() - self._c0
        self.t_elapsed += time.perf_counter() - self._w0
        self._c0 = self._w0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


@dataclass
class DecodeStats:
    """Per-utterance work counters (ngram_search_stats_t analog).

    The dense formulation evaluates everything each frame, so:
      n_hmm_eval   = frames x HMM nodes (P)
      n_senone_active_utt = frames x senones (all senones are "active")
      n_word_trans = frames x words (every word transition is scored)
    """

    n_frames: int = 0
    n_hmm_eval: int = 0
    n_senone_active_utt: int = 0
    n_word_trans: int = 0

    def add_utt(self, n_frames: int, n_hmm: int, n_sen: int, n_words: int):
        self.n_frames += n_frames
        self.n_hmm_eval += n_frames * n_hmm
        self.n_senone_active_utt += n_frames * n_sen
        self.n_word_trans += n_frames * n_words

    def reset(self):
        self.n_frames = self.n_hmm_eval = 0
        self.n_senone_active_utt = self.n_word_trans = 0


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
