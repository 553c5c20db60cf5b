"""The grammar, keyword, allphone (CI and triphone) and align searches
through their chunked runner (`search.base.ChunkGraph`: 16-frame chunks
over static buffers, the last T mod 16 frames stepped eagerly; on the
CPU the chunk runs without capture) against the JAX searches' `lax.scan`
records, bit for bit with dtypes, and against the same search with its
chunks called uncaptured (`graph=False`), at T = 37 (two chunks and a
tail), T = 11 (no whole chunk) and T = 32 (no tail).  A search keeps its
runner across utterances, and a rebuilt search (`Decoder.add_word`)
drops it; `Decoder._to(device, graph=False)` passes `graph` to every
search."""

from dataclasses import astuple

import numpy as np
import pytest
import torch

from pocketsphinx_tpu.lm.jsgf import Jsgf as JJsgf
from pocketsphinx_tpu.lm.ngram import read_lm as j_read_lm
from pocketsphinx_tpu.search.align import Aligner as JAligner
from pocketsphinx_tpu.search.allphone import AllphoneDecoder as JAllphone
from pocketsphinx_tpu.search.fsg import FsgDecoder as JFsgDecoder
from pocketsphinx_tpu.search.kws import (KwsDecoder as JKwsDecoder,
                                         parse_kws_file as j_parse)
from pocketsphinx_tpu_torch import Decoder
from pocketsphinx_tpu_torch.lm.jsgf import Jsgf
from pocketsphinx_tpu_torch.lm.ngram import read_lm
from pocketsphinx_tpu_torch.search.align import Aligner
from pocketsphinx_tpu_torch.search.allphone import AllphoneDecoder
from pocketsphinx_tpu_torch.search.base import CHUNK, ChunkGraph, frames
from pocketsphinx_tpu_torch.search.fsg import FsgDecoder
from pocketsphinx_tpu_torch.search.kws import KwsDecoder, parse_kws_file
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import (  # noqa: F401
    assert_records_equal, dictionary_with_alternates, model_pair,
    scan_outputs, tie_costs, torch_one_thread)

MODES = ("fsg", "kws", "allphone_ci", "allphone_tri", "align")
NAMES = {"fsg": "escore estf epra eascr final_score".split(),
         "kws": ["ratio", "stf"],
         "allphone_ci": ["out", "stf", "prc"],
         "allphone_tri": ["out", "stf", "prc"],
         "align": "src osrc ewin esrc out".split()}


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("mode_graph")
    dic = str(d / "alt.dic")
    words = dictionary_with_alternates(dic, n_words=30, seed=21)
    spec = synth.make_model([dic], seed=22, n_sen=126 + 300, n_density=8)
    pair = model_pair(spec, str(d), dic)
    gram = ("#JSGF V1.0; grammar cmd;\n"
            "public <cmd> = <verb> <object> [<mod>];\n"
            f"<verb> = {' | '.join(words[:6])};\n"
            f"<object> = {' | '.join(words[6:16])};\n"
            f"<mod> = {' | '.join(words[16:20])};\n")
    kws = synth.write_keyphrases(dic, str(d / "k.txt"), seed=23, n=6)
    lmf = synth.write_phone_arpa(str(d / "phone.arpa"), seed=24)
    text = [words[0], words[-1], words[1], words[5]]
    return pair, gram, kws, lmf, text


def searches(task, mode):
    """(the JAX search, the port's on the CPU, a function decoding costs
    with either and returning its result in a form equal across the
    packages)."""
    ((jam, jd2p), (pam, pd2p)), gram, kws, lmf, text = task
    if mode == "fsg":
        jx = JFsgDecoder(jam, jd2p, JJsgf(gram).build_fsg(lw=6.5))
        pt = FsgDecoder(pam, pd2p, Jsgf(gram).build_fsg(lw=6.5),
                        device="cpu")
    elif mode == "kws":
        jx = JKwsDecoder(jam, jd2p, j_parse(kws, 1e-30), plp=0.1, delay=0)
        pt = KwsDecoder(pam, pd2p, parse_kws_file(kws, 1e-30), plp=0.1,
                        delay=0, device="cpu")
    elif mode.startswith("allphone"):
        ci = mode == "allphone_ci"
        jx = JAllphone(jam, j_read_lm(lmf, lw=6.5, wip=0.65) if ci else None,
                       ci_only=ci, pip=0.9)
        pt = AllphoneDecoder(pam, read_lm(lmf, lw=6.5, wip=0.65) if ci
                             else None, ci_only=ci, pip=0.9, device="cpu")
    else:
        jx, pt = JAligner(jam, jd2p), Aligner(pam, pd2p, device="cpu")

    def run(search, costs):
        if mode == "align":
            return [[astuple(e) for e in level]
                    for level in search.align(None, text, costs=costs)]
        hyp, segs = search.decode(None, costs=costs)
        return hyp, [(s.word, s.start, s.end) for s in segs]
    return jx, pt, run


@pytest.mark.parametrize("T", [37, 11, 32])
@pytest.mark.parametrize("mode", MODES)
def test_runner_equals_jax_scan_and_eager(task, mode, T, monkeypatch):
    jx, pt, run = searches(task, mode)
    assert pt.graph and pt.chunk_graph is None
    costs = tie_costs(pt.am.n_sen, T, seed=T + len(mode),
                      tie_frame=T // 2)
    seen = scan_outputs(monkeypatch)
    out_j = run(jx, costs)
    jax_recs = seen[-1][1]
    out_p = run(pt, costs)
    runner = pt.chunk_graph
    assert isinstance(runner, ChunkGraph) and not runner.graphs
    assert_records_equal(pt.records, jax_recs, NAMES[mode])
    eager = pt.to("cpu", graph=False)
    assert eager.chunk_graph is None and not eager.graph
    out_e = run(eager, costs)
    assert eager.chunk_graph is not runner and not eager.chunk_graph.graphs
    assert_records_equal(eager.records, jax_recs, NAMES[mode])
    assert out_p == out_e == out_j
    # the frame index reaches the records as int32 on both paths
    for r in pt.records:
        assert r.dtype != np.int64


@pytest.mark.parametrize("mode", ["fsg", "kws", "allphone_tri"])
def test_runner_kept_across_utterances(task, mode):
    _, pt, run = searches(task, mode)
    eager = pt.to("cpu", graph=False)
    for i, T in enumerate((40, 23, CHUNK)):
        costs = tie_costs(pt.am.n_sen, T, seed=50 + i)
        a, b = run(pt, costs), run(eager, costs)
        if i == 0:
            runner = pt.chunk_graph
        assert pt.chunk_graph is runner
        assert a == b
        for x, y in zip(pt.records, eager.records):
            np.testing.assert_array_equal(x, y)


def test_align_runner_per_call(task):
    """The aligner's network is its text's: each `align` makes its own
    runner, as the JAX scan compiles per shape."""
    *_, text = task
    _, pt, run = searches(task, "align")
    costs = tie_costs(pt.am.n_sen, 30, seed=60)
    run(pt, costs)
    first = pt.chunk_graph
    run(pt, costs)
    assert pt.chunk_graph is not first and pt.chunk_graph is not None


@pytest.fixture(scope="module")
def facade_task(tmp_path_factory):
    d = tmp_path_factory.mktemp("mode_graph_facade")
    hmm, dic, _ = synth.small_task(str(d / "t"), seed=7)
    jsgf = synth.write_jsgf(dic, str(d / "g.gram"), seed=1, sizes=(6, 12, 4))
    kws = synth.write_keyphrases(dic, str(d / "k.txt"), seed=2, n=5)
    return hmm, dic, jsgf, kws


@pytest.mark.parametrize("flag", ["jsgf", "kws"])
def test_add_word_drops_runner(facade_task, flag):
    hmm, dic, jsgf, kws = facade_task
    dec = Decoder(hmm=hmm, dict=dic, device="cpu",
                  **{flag: jsgf if flag == "jsgf" else kws})
    pcm = synth.make_pcm(5, 0.9)
    twin = dec._to("cpu", graph=False)
    assert all(not s.graph for s in twin._searches.values())
    h = dec.decode_raw(pcm.tobytes())
    search = dec._searches[dec.current_search_name()]
    assert search.chunk_graph is not None
    ht = twin.decode_raw(pcm.tobytes())
    assert (h is None) == (ht is None)
    assert h is None or h.hypstr == ht.hypstr
    dec.add_word("zzword", "AH B", True)
    assert search.chunk_graph is None
    twin = dec._to("cpu", graph=False)
    h2, ht2 = dec.decode_raw(pcm.tobytes()), twin.decode_raw(pcm.tobytes())
    assert search.chunk_graph is not None
    assert (h2 is None) == (ht2 is None)
    assert h2 is None or h2.hypstr == ht2.hypstr
    for a, b in zip(search.records,
                    twin._searches[dec.current_search_name()].records):
        np.testing.assert_array_equal(a, b)


def test_runner_frame_index_is_int32_tensor():
    """The chunk hands the step a 0-d int32 tensor, numbered from t0,
    and the tail frames likewise."""
    seen = []

    def step(carry, x, t):
        seen.append((t.dtype, t.dim(), int(t)))
        return carry + x, (carry * 0 + t,)

    run = ChunkGraph("cpu", key=None)
    xs = (torch.ones(CHUNK + 3, dtype=torch.int32),)
    recs, carry = run.run(frames(step), torch.zeros((), dtype=torch.int32),
                          xs, CHUNK + 3, t0=5)
    assert {(d, n) for d, n, _ in seen} == {(torch.int32, 0)}
    assert [v for *_, v in seen] == list(range(5, 5 + CHUNK + 3))
    assert recs[0].dtype == torch.int32
    assert recs[0].tolist() == list(range(5, 5 + CHUNK + 3))
    assert int(carry) == CHUNK + 3
