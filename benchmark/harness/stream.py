"""The live entry point: the `Decoder` facade at B=1, one stream, one
utterance after another (a closed loop, without real-time pacing).

Each utterance is what `examples/torch_stream_server.py` does for one:
`start_utt`, `process_raw` of 0.1 s int16 chunks, `partial_hyp` after
every `partial_every`-th chunk, then `end_utt`, `hyp` and `seg`.  Every
utterance starts from the model's initial CMN (`set_cmn`), as a new
connection of the stream server does, so that each is decoded alone.
One stream decodes slower than real time, so the unpaced loop runs
above what a live stream offers: the end-to-end metric is the audio
decoded per second, and the waits (each chunk's, each end's) are the
facade's per-layer metrics.  The window runs whole passes over the
mix's utterances until `--seconds` have passed (every seed, the same
work), and times each chunk (with its partial) and each utterance's
end; the check runs utterances drawn from the seed, the longest among
them, through the reference's facade and compares every partial
hypothesis, the final hypothesis, its segments, scores and
posteriors."""

from __future__ import annotations

import gc
import time
from contextlib import nullcontext

from . import traffic
from .task import prepare
from .trace import traced


def _utterance(dec, pcm, cmn0, step: int, every: int, span=nullcontext):
    """One utterance through `dec`; returns (outputs, chunk seconds,
    partial seconds, end seconds).  `span(name)` wraps each call into
    the facade (the profiler's `record_function` in a traced run)."""
    clock = time.perf_counter
    dec.set_cmn(cmn0)
    dec.start_utt()
    partials, chunk_s, partial_s = [], [], []
    for k, c0 in enumerate(range(0, len(pcm), step)):
        t0 = clock()
        with span("bench.process_raw"):
            dec.process_raw(pcm[c0:c0 + step])
        if (k + 1) % every == 0:
            t1 = clock()
            with span("bench.partial_hyp"):
                h = dec.partial_hyp()
            partials.append(h.hypstr if h else None)
            partial_s.append(clock() - t1)
        chunk_s.append(clock() - t0)
    t0 = clock()
    with span("bench.end_utt"):
        dec.end_utt()
        h = dec.hyp()
        segs = [(s.word, int(s.start_frame), int(s.end_frame),
                 float(s.ascore), float(s.lscore), float(s.prob))
                for s in dec.seg_iter()]
    end_s = clock() - t0
    final = (h.hypstr, float(h.score), float(h.prob)) if h else None
    return dict(partials=partials, final=final, segs=segs), chunk_s, \
        partial_s, end_s


class Stream:
    def __init__(self, cell, seed: int, device, workdir: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.workdir = workdir
        mix = cell.mix
        self.step = int(round(mix["chunk_s"] * traffic.SAMPRATE))
        self.every = mix["partial_every"]

    def _decoder(self, cls):
        conf = self.cell.config
        return cls(hmm=self.task["hmm"], dict=self.task["dict"],
                   lm=self.task["lm"], lw=conf["lw"], wip=conf["wip"],
                   device=self.device)

    def inputs(self) -> dict:
        """The model files and the utterances, from the seed; their
        seconds."""
        self.task = prepare(self.cell.config, self.seed, self.workdir)
        t0 = time.perf_counter()
        self.utts = traffic.stream_utterances(self.cell.mix, self.seed)
        self.done = [(u, None) for u in range(len(self.utts))]
        return dict(model_files_s=self.task["seconds"],
                    traffic_s=time.perf_counter() - t0)

    def setup(self) -> dict:
        from pocketsphinx_tpu_torch import Decoder

        parts = self.inputs()
        t0 = time.perf_counter()
        self.dec = self._decoder(Decoder)
        parts["decoder_s"] = time.perf_counter() - t0
        self.cmn0 = self.dec.get_cmn()
        # the shortest utterance warms the stream blocks, the flush and the
        # best-path pass (the LM's host maps are built on first use)
        t0 = time.perf_counter()
        shortest = min(range(len(self.utts)), key=lambda i: len(self.utts[i]))
        _utterance(self.dec, self.utts[shortest], self.cmn0, self.step,
                   self.every)
        parts["warmup_s"] = time.perf_counter() - t0
        return parts

    def window(self, seconds: float, trace: bool) -> dict:
        import torch
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        done, chunk_s, partial_s, end_s, blocks = [], [], [], [], []
        span = torch.profiler.record_function if trace else nullcontext
        with traced(trace, self.device) as tr:
            t0 = time.perf_counter()
            i = 0
            while True:
                u = i % len(self.utts)
                out, cs, ps, es = _utterance(self.dec, self.utts[u],
                                             self.cmn0, self.step,
                                             self.every, span)
                done.append((u, out))
                chunk_s += cs
                partial_s += ps
                end_s.append(es)
                blocks += self.dec.stream_block_seconds
                i += 1
                # whole passes over the pool: every seed, the same work
                if i % len(self.utts) == 0 and \
                        time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
        self.done = done
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        audio = sum(len(self.utts[u]) for u, _ in done) / traffic.SAMPRATE
        return dict(
            window_s=t1 - t0, attempted=len(done), peak_bytes=peak,
            chunk_s=chunk_s, partial_s=partial_s, end_s=end_s,
            block_s=blocks, trace=tr.get("trace"),
            e2e={"audio_s_per_s.stream": audio / (t1 - t0),
                 "peak_mem_gib": peak / 2 ** 30})

    def free(self):
        import torch
        self.dec = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference and the check ------------------------------------

    def checked(self) -> list[int]:
        """The utterances the check runs again: the longest of those the
        window completed, and more drawn from the seed."""
        n = min(len(self.utts), len(self.done))
        k = self.cell.mix["check"]["utterances"]
        longest = max(range(n), key=lambda i: len(self.utts[i]))
        rest = [i for i in range(n) if i != longest]
        pick = [rest[j] for j in traffic.sample(self.seed, len(rest), k - 1)]
        return sorted([longest] + pick)

    def port_outputs(self) -> dict:
        last = {u: out for u, out in self.done}
        return {u: last[u] for u in self.checked()}

    def reference(self, tf32: bool = False) -> dict:
        import torch
        from ..reference.psref.decoder import Decoder

        if getattr(self, "ref", None) is None:
            self.ref = self._decoder(Decoder)
        dec = self.ref
        cmn0 = dec.get_cmn()
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            return {u: _utterance(dec, self.utts[u], cmn0, self.step,
                                  self.every)[0] for u in self.checked()}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        """Partial hypotheses that differ, utterances whose final
        hypothesis or segment words and frames differ, and the widest
        gaps of a score (the hypothesis's, each segment's acoustic and LM
        score) and of a posterior."""
        partials = finals = 0
        score = prob = 0.0
        for u, r in ref.items():
            g = got.get(u)
            if g is None:
                finals += 1
                continue
            partials += sum(a != b for a, b in zip(g["partials"],
                                                   r["partials"]))
            partials += abs(len(g["partials"]) - len(r["partials"]))
            words = lambda o: (o["final"] and o["final"][0],  # noqa: E731
                               [s[:3] for s in o["segs"]])
            if words(g) != words(r) or len(g["segs"]) != len(r["segs"]):
                finals += 1
                continue
            if g["final"] and r["final"]:
                score = max(score, abs(g["final"][1] - r["final"][1]))
                prob = max(prob, abs(g["final"][2] - r["final"][2]))
            for a, b in zip(g["segs"], r["segs"]):
                score = max(score, abs(a[3] - b[3]), abs(a[4] - b[4]))
                prob = max(prob, abs(a[5] - b[5]))
        return dict(partials_differ=float(partials),
                    finals_differ=float(finals), score_gap=score,
                    prob_gap=prob)

    def layer_context(self, res: dict, ref: dict) -> dict:
        return dict(trace=res["trace"], window_s=res["window_s"],
                    block_seconds=res["block_s"],
                    partial_seconds=res["partial_s"],
                    chunk_seconds=res["chunk_s"], end_seconds=res["end_s"])
