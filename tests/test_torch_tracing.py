"""The corpus path's spans and counters (`pocketsphinx_tpu_torch.profile`)
on the CPU, at a small synthetic task:

  * under `torch.profiler`, `decode_corpus` records every "ps." span of
    its path, each inside the span the path nests it in, one
    "ps.scan.chunk" per chunk stepped; `ChunkGraph.run` marks its chunks
    and its eager tail;
  * the counters add up to what the batches hold: batch x frames padded
    to whole chunks, the utterances' frames, and the blocking reads of
    results (the frame counts, one per segment step of the walk and one
    to end it, five copies of the backtrace's outputs);
  * results and stage timers do not depend on the profiler or on the
    `timings` dict, and without either a span opens no profiler range.

No JAX: the port against itself."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from pocketsphinx_tpu_torch import profile
from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend
from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline
from pocketsphinx_tpu_torch.search import ngram_fused
from pocketsphinx_tpu_torch.search.base import CHUNK, ChunkGraph
from pocketsphinx_tpu_torch.testing import synth

CFG = dict(nfilt=25, lowerf=130, upperf=6800, transform="dct",
           lifter_val=22, remove_noise=True)        # en-us feat.params
SECONDS = (1.2, 0.9, 1.1, 1.2, 1.0)       # batch_size 2: batches 2, 2, 1
#: each span of the corpus path -> the span it lies in
PARENT = {"ps.corpus": None, "ps.batch": "ps.corpus",
          "ps.frontend": "ps.batch", "ps.frontend.pcm": "ps.frontend",
          "ps.frontend.mfcc": "ps.frontend",
          "ps.frontend.features": "ps.frontend",
          "ps.scoring": "ps.batch", "ps.scan": "ps.batch",
          "ps.scan.chunk": "ps.scan", "ps.backtrace": "ps.batch",
          "ps.backtrace.to_host": "ps.backtrace", "ps.segments": "ps.batch"}
STAGES = {"frontend", "scoring", "scan", "backtrace"}


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tracing"))
    dic = d + "/small.dic"
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=1)
    lmf = synth.write_arpa(words, d + "/small.arpa", seed=2)
    spec = synth.make_model([dic], seed=3, n_sen=126 + 300, n_density=16)
    dec = synth.build_decoder(spec, d, dic, lmf, topk=16, device="cpu")
    pcms = [synth.make_pcm(60 + i, s).astype(np.float32)
            for i, s in enumerate(SECONDS)]
    return BatchDecodePipeline(dec, MelFrontend(**CFG)), pcms


@pytest.fixture(scope="module")
def plain(task):
    """The results with neither a profiler nor a `timings` dict."""
    return _decode(task)[0]


def _key(results):
    return [(h, [(s.word, s.start, s.end) for s in segs])
            for h, segs in results]


def _spans(prof):
    """The "ps." spans of a profile: (name, start ns, end ns)."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("ps.")]


def _parent(spans, s):
    """The innermost other span that holds span `s`, or None."""
    inner = [t for t in spans if t is not s and t[1] <= s[1]
             and s[2] <= t[2]]
    return min(inner, key=lambda t: t[2] - t[1], default=(None,))[0]


def _decode(task, timings=None, traced=False):
    pipe, pcms = task
    if not traced:
        return _key(pipe.decode_corpus(pcms, batch_size=2,
                                       timings=timings)), None
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _key(pipe.decode_corpus(pcms, batch_size=2, timings=timings))
    return out, _spans(prof)


def test_spans_nest_as_the_path(task, plain, monkeypatch):
    chunks = []
    run = ngram_fused._ScanGraph.run

    def counted(self, *a):
        chunks.append(1)
        return run(self, *a)
    monkeypatch.setattr(ngram_fused._ScanGraph, "run", counted)
    out, spans = _decode(task, traced=True)
    assert out == plain
    names = [s[0] for s in spans]
    assert set(names) == set(PARENT)
    for s in spans:
        assert _parent(spans, s) == PARENT[s[0]], s[0]
    assert names.count("ps.corpus") == 1
    assert names.count("ps.batch") == 3
    assert names.count("ps.scan.chunk") == len(chunks) >= 3


def test_counters_are_the_batches(task):
    """Each counter's increase over a call equals what its batches give:
    B x T padded to CHUNK, the sum of the frame counts, and 7 + the most
    segments of any utterance of the batch reads of results."""
    pipe, _ = task
    search = pipe.replicas[0]
    seen = []
    decode = search.decode_batch

    def spy(feats, n_frames, **kw):
        out = decode(feats, n_frames, **kw)
        seen.append((feats.shape[0], feats.shape[1], n_frames.tolist(),
                     max(len(segs) for _, segs in out)))
        return out
    search.decode_batch = spy
    try:
        before = profile.counters()
        _decode(task)
        after = profile.counters()
    finally:
        del search.decode_batch
    got = {k: after[k] - before.get(k, 0)
           for k in ("scan.batches", "scan.lane_frames", "scan.real_frames",
                     "host_syncs")}
    assert len(seen) == 3 and all(n > 0 for *_, n in seen)
    assert got == {
        "scan.batches": 3,
        "scan.lane_frames": sum(B * -(-T // CHUNK) * CHUNK
                                for B, T, _, _ in seen),
        "scan.real_frames": sum(sum(nf) for _, _, nf, _ in seen),
        "host_syncs": sum(7 + n for *_, n in seen)}
    assert got["scan.real_frames"] < got["scan.lane_frames"]
    assert "capture_s" not in after or after["capture_s"] == before.get(
        "capture_s")


@pytest.mark.parametrize("traced", [False, True], ids=["off", "profiled"])
def test_results_and_timers_do_not_depend_on_tracing(task, plain, traced):
    timings = {}
    out, spans = _decode(task, timings=timings, traced=traced)
    assert out == plain
    assert set(timings) == STAGES and all(v > 0 for v in timings.values())
    if traced:
        assert {s[0] for s in spans} == set(PARENT)


def test_no_profiler_no_dict_opens_nothing(task, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profile.span("ps.x").__enter__() is None
    timings = {}
    with profile.span("ps.x", timings, "x"):
        pass
    assert set(timings) == {"x"}
    _decode(task)


def test_timings_add_up():
    timings = {"x": 1.0}
    with profile.span("ps.x", timings, "x", torch.device("cpu")):
        pass
    assert timings["x"] > 1.0


def test_counters_across_threads():
    """`count` from many threads loses no update."""
    import sys
    import threading
    before = profile.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            profile.count("test.threads") for _ in range(2000)])
            for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert profile.counters()["test.threads"] - before == 8 * 2000


def test_chunk_graph_marks_chunks_and_tail():
    """`ChunkGraph.run` (the mode and flat searches' runner) marks each
    whole chunk and the eager tail, and steps what an eager loop does."""
    T = 2 * CHUNK + 5
    xs = (torch.arange(T, dtype=torch.float32)[:, None].repeat(1, 3),)

    def step(carry, x, t):
        carry = carry * 0.5 + x
        return carry, (carry, t + torch.zeros((), dtype=torch.int32))
    run = ChunkGraph("cpu", key=None)
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        recs, carry = run.run(step, torch.zeros(3), xs, T, t0=7)
    names = [s[0] for s in _spans(prof)]
    assert names.count("ps.scan.chunk") == 2
    assert names.count("ps.scan.tail") == 1
    want = torch.zeros(3)
    for t in range(T):
        want = want * 0.5 + xs[0][t]
        assert torch.equal(recs[0][t], want) and int(recs[1][t]) == 7 + t
    assert torch.equal(carry, want)
