"""Whole runs on the CPU at the tiny shape: a cell added by entries alone
runs by name, the import guard, and the check failing when the timed
path is broken underneath."""

import sys
import types

import pytest

from benchmark.harness.guard import forbidden_modules
from conftest import run_cell


def test_guard_names():
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla", "flax",
                              "pocketsphinx_tpu.decoder",
                              "pocketsphinx_tpu_torch",
                              "pocketsphinx_tpu_torch.ops", "numpy",
                              "jaxtyping"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "pocketsphinx_tpu.decoder"]


def test_tiny_batch_cell_runs_by_name(spec_path):
    rc, line, err = run_cell(spec_path, "tiny.batch")
    assert rc == 0, err
    assert line["correct"] is True
    assert set(line["metrics"]) == {"audio_s_per_s", "peak_mem_gib",
                                    "setup_s"}
    # the window runs every call of the mix at least once
    assert line["attempted"] == 2 * 16
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"utts_differ", "score_gap", "feat_gap",
                                   "senone_gap"}
    assert err.strip().splitlines()[-1].startswith("senone_gap ")


def test_data_parallel_cell_by_entries_alone(spec_path):
    """A cell over a two-row data mesh is an entry and nothing else: the
    pipeline gets one data row per chip the cell asks for, and the check
    mirrors its split of each batch."""
    import json
    from benchmark.harness.cells import load_cell
    from benchmark.harness.corpus import Corpus
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": "tiny.quick-dp2", "config": "tiny",
                              "traffic": "quick", "chips": 2,
                              "why": "test only"})
    for m in spec["per_layer"]:
        m["workloads"].append("tiny.quick-dp2")
    spec_path.write_text(json.dumps(spec))
    rc, line, err = run_cell(spec_path, "tiny.quick-dp2")
    assert rc == 0, err
    assert line["correct"] is True and line["device"]["count"] == 2
    from conftest import DATA
    drv = Corpus(load_cell("tiny.quick-dp2", spec_path, DATA / "traffic"),
                 5, None, "")
    drv.calls = [[b"x" * n for n in (5, 1, 3, 2, 4)]]
    assert drv._batches(drv.calls[0]) == [[(0, [1]), (1, [3])],
                                          [(0, [2]), (1, [4])], [(0, [0])]]


def test_quick_cell_traced(spec_path):
    rc, line, err = run_cell(spec_path, "tiny.quick", trace=1)
    assert rc == 0, err
    m = line["metrics"]
    # the stage timers' metrics; no device on the CPU, so no roofline
    assert {"frontend_ms_per_audio_s", "scoring_ms_per_frame",
            "scan_ms_per_frame", "backtrace_ms_per_batch",
            "host_launches_per_frame", "step_mfu"} <= set(m)
    assert "fan_roofline" not in m and "idle_share" not in m
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert "breakdown" in line


def test_stream_cell(spec_path):
    rc, line, err = run_cell(spec_path, "tiny.stream")
    assert rc == 0, err
    assert line["correct"] is True
    assert {"audio_s_per_s.stream", "peak_mem_gib",
            "setup_s"} == set(line["metrics"])


def test_stream_cell_traced(spec_path):
    rc, line, err = run_cell(spec_path, "tiny.stream", trace=1)
    assert rc == 0, err
    assert {"chunk_ms_p95", "final_ms_p50", "block_ms_p50",
            "partial_ms_p50"} <= set(line["metrics"])


def test_guard_refuses_jax(spec_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line, err = run_cell(spec_path, "tiny.stream")
    assert rc != 0 and line is None
    assert "jax" in err


def _alter_word(monkeypatch):
    """A word of every hypothesis altered where the search makes it."""
    from pocketsphinx_tpu_torch.search import ngram_fused
    orig = ngram_fused.NgramFusedDecoder._segs_from_table

    def bad(self, table, n):
        hyp, segs = orig(self, table, n)
        if segs:
            segs[-1].word = self.dict.wordstr(self.words[0])
        return self._hyp_of(segs), segs
    monkeypatch.setattr(ngram_fused.NgramFusedDecoder, "_segs_from_table",
                        bad)


def _alter_walk(monkeypatch):
    """A word of the stream's host walk (its partial hypotheses) altered
    where the walk makes it."""
    from pocketsphinx_tpu_torch.search import ngram_fused
    orig = ngram_fused.NgramFusedDecoder._backtrace

    def bad(self, recs, T):
        hyp, segs = orig(self, recs, T)
        return hyp + " x", segs
    monkeypatch.setattr(ngram_fused.NgramFusedDecoder, "_backtrace", bad)


def _alter_best_path(monkeypatch):
    """The last word of the best path altered where the lattice makes
    it."""
    from pocketsphinx_tpu_torch.search import lattice
    orig = lattice.Lattice.bestpath

    def bad(self, *a, **kw):
        hyp, segs, score = orig(self, *a, **kw)
        if segs:
            w, s, e = segs[-1]
            segs = segs[:-1] + [("<sil>" if w != "<sil>" else "</s>", s, e)]
        return hyp, segs, score
    monkeypatch.setattr(lattice.Lattice, "bestpath", bad)


def _half_batch(monkeypatch):
    """Half of each batch left out: its rows get the first row's
    result."""
    from pocketsphinx_tpu_torch.search import ngram_fused
    orig = ngram_fused.NgramFusedDecoder.decode_batch

    def bad(self, feats, n_frames, *a, **kw):
        out = orig(self, feats, n_frames, *a, **kw)
        h = len(out) // 2
        self.hyp_scores[h:] = [self.hyp_scores[0]] * (len(out) - h)
        return out[:h] + [out[0]] * (len(out) - h)
    monkeypatch.setattr(ngram_fused.NgramFusedDecoder, "decode_batch", bad)


def _alter_partial(monkeypatch):
    from pocketsphinx_tpu_torch import decoder
    orig = decoder.Decoder.partial_hyp

    def bad(self):
        h = orig(self)
        return decoder.Hypothesis(hypstr=(h.hypstr if h else "") + " x")
    monkeypatch.setattr(decoder.Decoder, "partial_hyp", bad)


def _alter_score(monkeypatch):
    """The best path's score off by one unit where the facade makes it."""
    from pocketsphinx_tpu_torch import decoder
    orig = decoder.Decoder.hyp

    def bad(self):
        h = orig(self)
        return decoder.Hypothesis(h.hypstr, h.score + 1, h.prob,
                                  h.best_score) if h else h
    monkeypatch.setattr(decoder.Decoder, "hyp", bad)


def _alter_feats(monkeypatch):
    """One feature of every batch off by a thousandth where the frontend
    makes it."""
    from pocketsphinx_tpu_torch.frontend import feat
    orig = feat.compute_feats

    def bad(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0, 0, 0, 0] += 1e-3
        return out
    monkeypatch.setattr(feat, "compute_feats", bad)


def _alter_costs(monkeypatch):
    """One senone cost of every batch off by one unit where the scoring
    makes it."""
    from pocketsphinx_tpu_torch.search import ngram_fused
    orig = ngram_fused.senone_scores

    def bad(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0, 0, 0] += 1.0
        return out
    monkeypatch.setattr(ngram_fused, "senone_scores", bad)


def _stuck_step(monkeypatch):
    """A scan step that returns its state unchanged."""
    from pocketsphinx_tpu_torch.search import ngram_fused
    orig = ngram_fused.NgramFusedDecoder._step

    def bad(self, carry, *a, **kw):
        return carry, orig(self, carry, *a, **kw)[1]
    monkeypatch.setattr(ngram_fused.NgramFusedDecoder, "_step", bad)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.quick", _alter_word), ("tiny.quick", _half_batch),
    ("tiny.quick", _stuck_step), ("tiny.quick", _alter_feats),
    ("tiny.quick", _alter_costs), ("tiny.stream", _stuck_step),
    ("tiny.stream", _alter_walk), ("tiny.stream", _alter_best_path),
    ("tiny.stream", _alter_partial),
    ("tiny.stream", _alter_score)])
def test_fault_is_not_correct(spec_path, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line, err = run_cell(spec_path, cell)
    assert rc == 0, err
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
