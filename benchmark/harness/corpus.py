"""The corpus entry point: `BatchDecodePipeline.decode_corpus` on one
card, called back to back by one caller (a closed loop).

Set-up builds the pipeline as a user does (`examples/torch_batch.py`,
with the fused n-gram search) and warms it with one call of the mix,
whose shapes every later call repeats.  The window times whole
calls; the rate is the audio of the calls over the time they took.  The
mesh has one data row per card the cell asks for.  The check decodes one
call, drawn from the seed, again through the reference in the batches
the pipeline makes of it, and compares every utterance's hypothesis and
segments, every path score of the call, and the features and senone
costs of each card's first batch, which the window keeps as the timed
path makes them.  The reference computes the features of the
configuration's `feat` (`reference/feat/<feat>.py`), so a program that
makes another type fails `feat_gap`."""

from __future__ import annotations

import gc
import threading
import time
from contextlib import contextmanager, nullcontext

import numpy as np

from . import traffic
from .cells import feat_type
from .task import prepare
from .trace import traced


def _card_sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _segs(segs):
    return [(s.word, int(s.start), int(s.end)) for s in segs]


def _gap(a, b) -> float:
    """The widest gap between two arrays; inf where either is missing,
    their shapes differ, or a gap is not a number."""
    if a is None or b is None or np.shape(a) != np.shape(b):
        return float("inf")
    if np.size(a) == 0:
        return 0.0
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float("inf") if np.isnan(d).any() else float(d.max())


class Corpus:
    def __init__(self, cell, seed: int, device, workdir: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.workdir = workdir
        self.B = cell.mix["batch_size"]
        #: the mesh's data rows, one per card
        self.dp = cell.chips

    def inputs(self) -> dict:
        """The model files and the calls, from the seed; their seconds.
        `cmn_batch` has to be "batch", the CMN of the program's batch
        path."""
        conf = self.cell.config
        if conf.get("cmn_batch", "batch") != "batch":
            raise ValueError(f"cmn_batch = {conf['cmn_batch']!r}: the batch "
                             f"path takes 'batch'")
        self.task = prepare(conf, self.seed, self.workdir)
        t0 = time.perf_counter()
        self.calls = traffic.corpus_calls(self.cell.mix, self.seed)
        #: the call the check decodes again, drawn from the seed
        self.checked = traffic.sample(self.seed, len(self.calls), 1)[0]
        return dict(model_files_s=self.task["seconds"],
                    traffic_s=time.perf_counter() - t0)

    # -- the program ----------------------------------------------------

    def setup(self) -> dict:
        from pocketsphinx_tpu_torch.fileio.dictionary import Dictionary
        from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend
        from pocketsphinx_tpu_torch.lm.ngram import read_lm
        from pocketsphinx_tpu_torch.models.acoustic import AcousticModel
        from pocketsphinx_tpu_torch.models.dict2pid import Dict2Pid
        from pocketsphinx_tpu_torch.parallel import (BatchDecodePipeline,
                                                     make_mesh)
        from pocketsphinx_tpu_torch.search.ngram_fused import \
            NgramFusedDecoder

        conf, parts = self.cell.config, self.inputs()
        t0 = time.perf_counter()
        am = AcousticModel.load(self.task["hmm"])
        d2p = Dict2Pid(am.mdef, Dictionary(am.mdef, self.task["dict"],
                                           self.task["noisedict"]))
        parts["model_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lm = read_lm(self.task["lm"], lw=conf["lw"], wip=conf["wip"])
        parts["lm_read_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.dec = NgramFusedDecoder(am, d2p, lm, device=self.device)
        parts["build_s"] = _card_sync(self.device) - t0
        fe = MelFrontend(**conf["frontend"])
        self.pipe = BatchDecodePipeline(
            self.dec, fe, mesh=make_mesh(n_data=self.dp, device=self.device))
        self.cards = [row[0] for row in self.pipe.mesh.devices
                      if row[0].type == "cuda"]
        # one call warms every shape: all calls have the same lengths
        t0 = time.perf_counter()
        self.pipe.decode_corpus(self.calls[0], batch_size=self.B)
        parts["warmup_s"] = self._sync() - t0
        return parts

    def _sync(self):
        for d in self.cards:
            _card_sync(d)
        return time.perf_counter()

    @contextmanager
    def _tapped(self):
        """While the block runs, each search of the pipeline keeps, in
        `self.tap` when that is set, the path scores of each batch it
        decodes, and, for its first batch of a tap, the features it is
        handed and the senone costs the program's scoring makes of
        them."""
        from pocketsphinx_tpu_torch.search import ngram_fused
        local = threading.local()
        score = ngram_fused.senone_scores

        def senone_scores(*a, **kw):
            costs = score(*a, **kw)
            keep = getattr(local, "keep", None)
            if keep is not None:
                keep["costs"] = costs.cpu().numpy()
            return costs

        def tap(r, search):
            decode = search.decode_batch

            def decode_batch(feats, n_frames, **kw):
                t = self.tap
                keep = None
                if t is not None and t["front"][r] is None:
                    keep = t["front"][r] = dict(
                        feats=feats.cpu().numpy()
                        if hasattr(feats, "cpu") else np.asarray(feats))
                local.keep = keep
                try:
                    out = decode(feats, n_frames, **kw)
                finally:
                    local.keep = None
                if t is not None:
                    t["scores"][r].append(list(search.hyp_scores))
                return out
            search.decode_batch = decode_batch

        self.tap = None
        ngram_fused.senone_scores = senone_scores
        for r, search in enumerate(self.pipe.replicas):
            tap(r, search)
        try:
            yield
        finally:
            ngram_fused.senone_scores = score
            for search in self.pipe.replicas:
                vars(search).pop("decode_batch", None)
            self.tap = None

    def _new_tap(self, front):
        n = len(self.pipe.replicas)
        return dict(scores=[[] for _ in range(n)],
                    front=front if front is not None else [None] * n)

    def window(self, seconds: float, trace: bool) -> dict:
        """Calls back to back until `seconds` have passed and every call
        of the mix has run.  Each run of the checked call keeps its path
        scores; its first run also keeps each card's first batch's
        features and senone costs (one copy to the host in the window)."""
        import torch
        done, timings = [], {}
        for d in self.cards:
            torch.cuda.reset_peak_memory_stats(d)
        span = torch.profiler.record_function if trace else nullcontext
        front = None
        with self._tapped(), traced(trace, self.device,
                                    max(len(self.cards), 1)) as tr:
            t0 = self._sync()
            i = 0
            while True:
                c = i % len(self.calls)
                st = {} if trace else None
                self.tap = (self._new_tap(front) if c == self.checked
                            else None)
                with span("bench.decode_corpus"):
                    out = self.pipe.decode_corpus(self.calls[c],
                                                  batch_size=self.B,
                                                  timings=st)
                self._sync()
                if self.tap is not None:
                    front = self.tap["front"]
                    done.append((c, [(h, _segs(s)) for h, s in out],
                                 self.tap))
                else:
                    done.append((c, None, None))
                for k, v in (st or {}).items():
                    timings[k] = timings.get(k, 0.0) + v
                i += 1
                if (i >= len(self.calls)
                        and time.perf_counter() - t0 >= seconds):
                    break
            t1 = self._sync()
        self.done = done
        audio = sum(sum(len(p) for p in self.calls[c]) for c, _, _ in done
                    ) / traffic.SAMPRATE
        peak = max((torch.cuda.max_memory_allocated(d) for d in self.cards),
                   default=0)
        res = dict(window_s=t1 - t0, audio_s=audio, calls=len(done),
                   attempted=sum(len(self.calls[c]) for c, _, _ in done),
                   peak_bytes=peak, timings=timings, trace=tr.get("trace"),
                   e2e=dict(audio_s_per_s=audio / (t1 - t0),
                            peak_mem_gib=peak / 2 ** 30))
        return res

    def free(self):
        import torch
        self.pipe = self.dec = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference and the check ------------------------------------

    def _batches(self, pcms):
        """The pipeline's batches of a call, as `decode_corpus` makes
        them: utterance indices sorted by length (a stable sort), B at a
        time, each split over the mesh's data rows; a list of (row,
        indices) per batch."""
        dp = self.dp
        B = (self.B // dp) * dp or dp
        order = sorted(range(len(pcms)), key=lambda i: len(pcms[i]))
        return [[(r, [int(i) for i in part]) for r, part in enumerate(
                    np.array_split(np.array(order[i0:i0 + B]), dp))
                 if len(part)]
                for i0 in range(0, len(order), B)]

    def reference(self, tf32: bool = False) -> dict:
        """The reference's decode of the checked call in the pipeline's
        batches: its results in input order, each row's path scores batch
        by batch and its first batch's features and senone costs, the
        frames each part of a batch steps, and the step's counts at the
        configuration's shapes (with the shapes they took)."""
        import torch
        from ..counts.kernels import step_counts, step_shapes
        from ..reference.psref.fileio.dictionary import Dictionary
        from ..reference.psref.frontend.mfcc import MelFrontend
        from ..reference.psref.lm.ngram import read_lm
        from ..reference.psref.models.acoustic import (AcousticModel,
                                                       senone_scores)
        from ..reference.psref.models.dict2pid import Dict2Pid
        from ..reference.psref.search.ngram_fused import NgramFusedDecoder

        conf = self.cell.config
        if getattr(self, "ref", None) is None:
            am = AcousticModel.load(self.task["hmm"])
            d2p = Dict2Pid(am.mdef, Dictionary(am.mdef, self.task["dict"],
                                               self.task["noisedict"]))
            lm = read_lm(self.task["lm"], lw=conf["lw"], wip=conf["wip"])
            self.ref = NgramFusedDecoder(am, d2p, lm, device=self.device)
        dec = self.ref
        if dec.lm_mode != conf["lm_mode"]:
            raise ValueError(f"LM mode {dec.lm_mode} != the configuration's "
                             f"{conf['lm_mode']}")
        fe = MelFrontend(**conf["frontend"])
        features = feat_type(conf).features
        pcms = self.calls[self.checked]
        results = [None] * len(pcms)
        scores = [[] for _ in range(self.dp)]
        front = [None] * self.dp
        frames = []
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            for batch in self._batches(pcms):
                for r, rows in batch:
                    pcm = np.zeros((len(rows),
                                    max(len(pcms[i]) for i in rows)),
                                   np.float32)
                    for k, i in enumerate(rows):
                        pcm[k, :len(pcms[i])] = pcms[i]
                    ns = np.array([len(pcms[i]) for i in rows], np.int32)
                    cep, nfr = fe.process_batch(pcm, ns, device=self.device)
                    feats = features(cep, nfr, "batch")
                    if front[r] is None:
                        costs = senone_scores(dec.scoring(), feats,
                                              time_chunk=16)
                        front[r] = dict(feats=feats.cpu().numpy(),
                                        costs=costs.cpu().numpy())
                        del costs
                    out = dec.decode_batch(feats, nfr, keep_records=False)
                    frames.append(int(feats.shape[1]))
                    for k, i in enumerate(rows):
                        results[i] = (out[k][0], _segs(out[k][1]))
                    scores[r].append(list(dec.hyp_scores))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        rows = max(self.B // self.dp, 1)
        shapes = step_shapes(dec)
        return dict(results=results, scores=scores, front=front,
                    frames=frames, shapes=shapes,
                    counts=step_counts(shapes, rows))

    def port_outputs(self) -> dict:
        """What the window's last run of the checked call produced."""
        last = [r for r in self.done if r[0] == self.checked][-1]
        return dict(results=last[1], scores=last[2]["scores"],
                    front=last[2]["front"])

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        """The numbers compared: utterances whose hypothesis or segments
        differ; the widest gap of a path score over every batch of the
        call; and the widest gaps of the features and of the senone
        costs of each data row's first batch."""
        differ = sum(a != b for a, b in zip(got["results"], ref["results"]))
        differ += abs(len(got["results"]) - len(ref["results"]))

        def flat(rows):
            return [x for batches in rows for b in batches for x in b]
        a, b = flat(got["scores"]), flat(ref["scores"])
        score_gap = _gap(a, b) if len(a) == len(b) else float("inf")
        feat_gap = senone_gap = 0.0
        if len(got["front"]) != len(ref["front"]):
            feat_gap = senone_gap = float("inf")
        for g, r in zip(got["front"], ref["front"]):
            g = g or {}
            r = r or {}
            feat_gap = max(feat_gap, _gap(g.get("feats"), r.get("feats")))
            senone_gap = max(senone_gap,
                             _gap(g.get("costs"), r.get("costs")))
        return dict(utts_differ=float(differ), score_gap=score_gap,
                    feat_gap=feat_gap, senone_gap=senone_gap)

    def layer_context(self, res: dict, ref: dict) -> dict:
        """What the per-layer readers read (`metrics/*.py`): per part of
        a batch on one data row, its padded frames."""
        return dict(timings=res["timings"], trace=res["trace"],
                    audio_s=res["audio_s"], window_s=res["window_s"],
                    batches=res["calls"] * len(ref["frames"]),
                    batch_frames=res["calls"] * sum(ref["frames"]),
                    counts=ref["counts"], chips=self.dp)
