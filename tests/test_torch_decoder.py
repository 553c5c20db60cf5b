"""The port's `Decoder` facade against the JAX package's, both loading
one synthetic model directory (`SynthModel.write_model_dir`, en-us's
feat.params), a 40-word dictionary and a seeded ARPA trigram LM:

  * `decode_senscr` on one cost matrix: the first-pass hyp, segments and
    score, then the best-path hyp, score, prob, segment posteriors and
    scores, the lattice lists and `nbest`, all exactly equal (the same
    search records and the same float64 host arithmetic);
  * `decode_raw` from PCM (utterances of one length, so that the JAX
    scan compiles once): features bit-equal (both host float64), costs
    within 2e-2 units (float32 sums in another order), hyps equal at the
    tested seeds;
  * streaming `process_raw` in 0.1 s chunks: the partial hyps after
    every chunk and the final hyp equal the JAX decoder's;
  * the rest of the API: `add_word` + re-decode, `lookup_word`,
    `get_cmn` / `set_cmn` across two utterances, the no-search error,
    the JAX decoder's errors for bad grammar, keyword and align calls,
    and `PS_NGRAM_IMPL=flat` (the flat search's first pass, best path and
    lattice equal to the JAX decoder's);
  * every other search mode through the constructor (`-fsg`, `-jsgf`,
    `-keyphrase`, `-kws`, `-allphone` CI with a phone LM and triphone
    without) and `add_align_text`: `decode_senscr` hyps and segments
    equal, for grammars also the best-path result, lattice lists and
    `nbest`, for alignment the word, phone and state entries (the JAX
    aligner is driven with the same costs directly, since its decoder
    scores features only); `activate_search` switching between the LM
    search and a grammar gives each one's own result."""

from dataclasses import astuple

import numpy as np
import pytest
import torch

from pocketsphinx_tpu.decoder import Decoder as JaxDecoder
from pocketsphinx_tpu.models.acoustic import senone_scores_jax
import pocketsphinx_tpu_torch
from pocketsphinx_tpu_torch import Decoder
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import torch_one_thread  # noqa: F401

CMN0 = "40,3,-1"


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    return synth.small_task(str(tmp_path_factory.mktemp("facade")), seed=7)


@pytest.fixture(scope="module")
def decoders(task):
    hmm, dic, lmf = task
    return (JaxDecoder(hmm=hmm, dict=dic, lm=lmf),
            Decoder(hmm=hmm, dict=dic, lm=lmf, device="cpu"))


def _hyp(dec):
    return astuple(dec.hyp())


def _segs(dec, post=False):
    return [(s.word, s.start_frame, s.end_frame)
            + ((s.prob, s.ascore, s.lscore) if post else ())
            for s in dec.seg_iter()]


def _lists(lat):
    return ([(n.word, n.sf, n.entries, n.exits) for n in lat.nodes],
            [(l.src, l.dst, l.ef, l.ascr, l.post) for l in lat.links],
            (lat.start, lat.end))


def test_exports_and_device():
    assert pocketsphinx_tpu_torch.Decoder is Decoder
    assert pocketsphinx_tpu_torch.Config().items() is not None
    with pytest.raises(AttributeError):
        pocketsphinx_tpu_torch.NoSuchThing


@pytest.mark.parametrize("seed,T", [(11, 96), (12, 96)])
def test_decode_senscr_equal(decoders, seed, T):
    jd, pd = decoders
    costs = np.random.default_rng(seed).uniform(
        0, 400, (T, pd.am.n_sen)).astype(np.float32)
    for d in decoders:
        d.config["bestpath"] = False
        d.decode_senscr(costs)
    assert _hyp(pd) == _hyp(jd)                      # first pass
    assert _segs(pd) == _segs(jd)
    assert pd.hyp().hypstr and pd.hyp().score < 0
    assert pd.get_lattice() is None
    for d in decoders:
        d.config["bestpath"] = True
        d.decode_senscr(costs)
    assert _hyp(pd) == _hyp(jd)                      # best path
    assert pd.hyp().prob < 1.0
    assert _segs(pd, post=True) == _segs(jd, post=True)
    assert _lists(pd.get_lattice()) == _lists(jd.get_lattice())
    assert pd.nbest(5) == jd.nbest(5)
    assert pd.n_frames == jd.n_frames == 0


@pytest.mark.parametrize("seed,sec", [(31, 2.0), (32, 2.0)])
def test_decode_raw_equal(decoders, seed, sec):
    jd, pd = decoders
    pcm = synth.make_pcm(seed, sec)
    for d in decoders:
        d.set_cmn(CMN0)
        d.decode_raw(pcm)
    np.testing.assert_array_equal(pd._feats, jd._feats)
    cp = pd._scores(pd._feats).numpy()
    cj = np.asarray(senone_scores_jax(jd.am.scoring_arrays, jd.am.cb_groups,
                                      jd._feats[None]))[0]
    np.testing.assert_allclose(cp, cj, atol=2e-2, rtol=0)
    assert pd.hyp().hypstr == jd.hyp().hypstr
    assert pd.hyp().hypstr
    assert [s[0] for s in _segs(pd)] == [s[0] for s in _segs(jd)]
    assert pd.get_cmn() == jd.get_cmn()
    n, cpu, wall = pd.get_utt_time()
    assert n == len(pd._feats) / 100 and wall > 0 and cpu > 0
    assert set(pd.all_perf.stages) == {"frontend", "search", "bestpath"}


def test_log_dirs_equal(decoders, tmp_path):
    """-rawlogdir / -mfclogdir / -senlogdir write the same dumps (senone
    scores as int16, so within one unit where the costs' 2e-2 differences
    straddle a rounding step)."""
    from pocketsphinx_tpu_torch.fileio.mfc import read_mfc, read_sen
    jd, pd = decoders
    pcm = synth.make_pcm(36, 2.0)
    dirs = []
    for name, d in (("j", jd), ("p", pd)):
        sub = {k: tmp_path / f"{name}{k}" for k in ("raw", "mfc", "sen")}
        for k, v in sub.items():
            v.mkdir()
            d.config[k + "logdir"] = str(v)
        d.set_cmn(CMN0)
        d.decode_raw(pcm)
        for k in sub:
            d.config[k + "logdir"] = None
        dirs.append({k: sorted(v.iterdir()) for k, v in sub.items()})
    (j, p) = dirs
    assert [f.name for f in p["raw"]] == [f.name for f in j["raw"]]
    assert p["raw"][-1].read_bytes() == j["raw"][-1].read_bytes()
    np.testing.assert_array_equal(read_mfc(str(p["mfc"][-1])),
                                  read_mfc(str(j["mfc"][-1])))
    sp, ap, _ = read_sen(str(p["sen"][-1]))
    sj, aj, _ = read_sen(str(j["sen"][-1]))
    assert sp.shape == sj.shape and ap.all() and aj.all()
    assert np.abs(sp.astype(int) - sj).max() <= 1
    assert np.array_equal(pd.get_rawdata(), pcm)
    pd.set_rawdata_size(100)
    assert np.array_equal(pd.get_rawdata(), pcm[-100:])


def test_streaming_partials_equal(decoders):
    jd, pd = decoders
    pcm = synth.make_pcm(33, 2.2)
    out = []
    for d in decoders:
        d.set_cmn(CMN0)
        d.start_utt()
        parts = []
        for c0 in range(0, len(pcm), 1600):              # 0.1 s chunks
            d.process_raw(pcm[c0:c0 + 1600])
            h = d.partial_hyp()
            parts.append(h.hypstr if h else None)
        d.end_utt()
        out.append((parts, d.hyp().hypstr, _segs(d), d.get_cmn()))
    assert out[1] == out[0]
    parts, hyp = out[1][0], out[1][1]
    assert hyp and any(parts) and parts[0] is None
    assert pd.n_frames == jd.n_frames > 200
    assert len(pd.stream_block_seconds) == -(-pd.n_frames // 32)


def test_cmn_carries_across_utterances(decoders):
    jd, pd = decoders
    pcms = [synth.make_pcm(34, 2.0), synth.make_pcm(35, 2.0)]
    for d in decoders:
        d.set_cmn(CMN0)
    got = []
    for pcm in pcms:
        for d in decoders:
            d.decode_raw(pcm)
        got.append((pd.get_cmn(), jd.get_cmn(), pd.hyp().hypstr,
                    jd.hyp().hypstr))
    assert all(a == b and h == g for a, b, h, g in got)
    assert got[0][0] != got[1][0] != CMN0           # the mean moved
    pd.set_cmn("1.5,2,3")
    assert pd.get_cmn().startswith("1.50,2.00,3.00,0.00")


def test_lookup_and_errors(task, decoders, monkeypatch):
    hmm, dic, lmf = task
    jd, pd = decoders
    words = [ln.split()[0] for ln in open(dic)]
    for w in words[:5] + ["nosuchword"]:
        assert pd.lookup_word(w) == jd.lookup_word(w)
    bare = Decoder(hmm=hmm, dict=dic, device="cpu")
    with pytest.raises(RuntimeError, match="No search module"):
        bare.decode_senscr(np.zeros((5, bare.am.n_sen), np.float32))
    # each call raises what the JAX decoder raises for it (and the
    # allphone search without an LM is built by both)
    for cls in (JaxDecoder, Decoder):
        kw = {"device": "cpu"} if cls is Decoder else {}
        with pytest.raises(FileNotFoundError, match="g.fsg"):
            cls(hmm=hmm, dict=dic, fsg="g.fsg", **kw)
        with pytest.raises(FileNotFoundError, match="k.txt"):
            cls(hmm=hmm, dict=dic, kws="k.txt", **kw)
    for d in decoders:
        with pytest.raises(ValueError, match="no usable keyphrases"):
            d.add_keyphrase("k", "a nosuchword")
        with pytest.raises(ValueError, match="no public rules"):
            d.add_jsgf_string("j", "#JSGF V1.0;")
        assert type(d.add_allphone("a", None)).__name__ == "AllphoneDecoder"
        d.remove_search("a")
        with pytest.raises(KeyError, match="Unknown word"):
            d.add_align_text("x")
        assert sorted(d._searches) == ["_default"]
    # PS_NGRAM_IMPL=flat: the flat search decodes the same costs to the
    # same first pass, best path and lattice as the JAX decoder's
    monkeypatch.setenv("PS_NGRAM_IMPL", "flat")
    costs = np.random.default_rng(15).uniform(
        0, 400, (80, pd.am.n_sen)).astype(np.float32)
    res = []
    for d in decoders:
        d.add_lm("flat", lmf)
        d.activate_search("flat")
        try:
            d.decode_senscr(costs)
            res.append((_hyp(d), _segs(d, post=True),
                        _lists(d.get_lattice())))
        finally:
            d.activate_search("_default")
            d.remove_search("flat")
    assert res[0] == res[1]
    assert res[1][0][0] and res[1][0][2] < 1.0
    assert type(pd.add_lm("flat", lmf)).__name__ == "NgramFlatDecoder"
    pd.remove_search("flat")


def test_device_defaults_to_cuda(task, monkeypatch):
    hmm, dic, lmf = task
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder(hmm=hmm, dict=dic, lm=lmf)


def test_read_lattice_equal(decoders, tmp_path):
    jd, pd = decoders
    costs = np.random.default_rng(14).uniform(
        0, 400, (96, pd.am.n_sen)).astype(np.float32)
    for d in decoders:
        d.decode_senscr(costs)
    path = str(tmp_path / "utt.lat")
    pd.get_lattice().write(path)
    lp, lj = pd.read_lattice(path), jd.read_lattice(path)
    assert pd.get_lattice() is lp and lp.n_links > 0
    assert _lists(lp) == _lists(lj)
    assert pd.nbest(3) == jd.nbest(3)


def test_load_dict_equal(task, tmp_path):
    """ps_load_dict: both decoders swap to a smaller dictionary and
    rebuild their search; a missing file leaves them unchanged."""
    hmm, dic, lmf = task
    sub = tmp_path / "sub.dic"
    sub.write_text("".join(open(dic).readlines()[::2]))
    jd = JaxDecoder(hmm=hmm, dict=dic, lm=lmf)
    pd = Decoder(hmm=hmm, dict=dic, lm=lmf, device="cpu")
    for d in (jd, pd):
        assert d.load_dict(str(tmp_path / "missing.dic")) == -1
        assert d.load_dict(str(sub)) == 0
    assert len(pd.dict) == len(jd.dict)
    assert pd._searches["_default"].W == jd._searches["_default"].W
    costs = np.random.default_rng(15).uniform(
        0, 400, (96, pd.am.n_sen)).astype(np.float32)
    for d in (jd, pd):
        d.decode_senscr(costs)
    assert _hyp(pd) == _hyp(jd)


def test_add_word_then_decode_equal(decoders):
    jd, pd = decoders
    for d in decoders:
        assert d.lookup_word("zzquux") is None
        d.add_word("zzquux", "Z AH K W AH K S")
        assert d.lookup_word("zzquux") == "Z AH K W AH K S"
    assert pd.dict.wordid("zzquux") == jd.dict.wordid("zzquux")
    search = pd._searches["_default"]
    assert search.W == jd._searches["_default"].W
    costs = np.random.default_rng(13).uniform(
        0, 400, (96, pd.am.n_sen)).astype(np.float32)
    for d in decoders:
        d.decode_senscr(costs)
    assert _hyp(pd) == _hyp(jd)
    assert _segs(pd, post=True) == _segs(jd, post=True)


@pytest.fixture(scope="module")
def mode_files(task, tmp_path_factory):
    from pocketsphinx_tpu_torch.testing.synth import (
        write_jsgf, write_keyphrases, write_phone_arpa)
    hmm, dic, lmf = task
    d = tmp_path_factory.mktemp("modes")
    words = [ln.split()[0] for ln in open(dic)]
    write_jsgf(dic, str(d / "cmd.gram"), seed=20, sizes=(6, 12, 4))
    fsg = "FSG_BEGIN cmd\nN 4\nS 0\nF 3\n" + "".join(
        f"T {a} {b} {p} {w}\n" for a, b, p, w in
        [(0, 1, 0.5, words[0]), (0, 1, 0.5, words[1]), (1, 2, 1.0, words[2]),
         (2, 1, 0.2, words[3]), (2, 3, 0.8, words[4])]) \
        + "T 1 3 0.1\nFSG_END\n"
    (d / "cmd.fsg").write_text(fsg)
    kws = write_keyphrases(dic, str(d / "k.txt"), seed=21, n=8)
    return dict(jsgf=str(d / "cmd.gram"), fsg=str(d / "cmd.fsg"), kws=kws,
                keyphrase=" ".join(words[3:5]),
                allphone=write_phone_arpa(str(d / "phone.arpa"), seed=22),
                words=words)


MODES = [("fsg", {}), ("jsgf", {}), ("keyphrase", {"kws_threshold": 1e-150}),
         ("kws", {}), ("allphone", {}), ("allphone", {"allphone_ci": False})]


@pytest.mark.parametrize("mode,extra", MODES,
                         ids=[m + ("_tri" if e.get("allphone_ci") is False
                                   else "") for m, e in MODES])
def test_search_modes_equal(task, mode_files, mode, extra):
    hmm, dic, _ = task
    kw = {mode: mode_files[mode], **extra}
    jd = JaxDecoder(hmm=hmm, dict=dic, **kw)
    pd = Decoder(hmm=hmm, dict=dic, device="cpu", **kw)
    costs = np.random.default_rng(23).uniform(
        0, 400, (96, pd.am.n_sen)).astype(np.float32)
    costs[40] = 200.0                        # a frame of ties everywhere
    for d in (jd, pd):
        d.decode_senscr(costs)
    assert _hyp(pd) == _hyp(jd)
    assert _segs(pd, post=True) == _segs(jd, post=True)
    if mode in ("fsg", "jsgf"):
        assert pd.hyp().hypstr and pd.get_lattice().n_links
        assert _lists(pd.get_lattice()) == _lists(jd.get_lattice())
        assert pd.nbest(4) == jd.nbest(4)
    else:
        assert pd.get_lattice() is None
    if mode in ("kws", "keyphrase"):
        assert pd.hyp().hypstr, "no detection to compare"


def test_align_text_equal(decoders, mode_files):
    jd, pd = decoders
    words = mode_files["words"][2:9]
    costs = np.random.default_rng(24).uniform(
        0, 400, (120, pd.am.n_sen)).astype(np.float32)
    try:
        for d in decoders:
            d.add_align_text(" ".join(words))
        assert pd.current_search_name() == "_align"
        pd.decode_senscr(costs)
        ej = jd._searches["_align"].align(None, words, costs=costs)
        for level_p, level_j in zip(pd.get_alignment(), ej):
            assert [astuple(e) for e in level_p] == \
                [astuple(e) for e in level_j]
        assert pd.hyp().hypstr == " ".join(words)
        assert _segs(pd) == [(w.text, w.start, w.start + w.duration - 1)
                             for w in ej[0]]
    finally:
        for d in decoders:
            d._searches.pop("_align", None)
            d.activate_search("_default")


def test_activate_search_switches(decoders, mode_files):
    jd, pd = decoders
    costs = np.random.default_rng(25).uniform(
        0, 400, (96, pd.am.n_sen)).astype(np.float32)
    gram = open(mode_files["jsgf"]).read()
    out = []
    try:
        for d in decoders:
            d.add_jsgf_string("cmd", gram)
            got = []
            for name in ("_default", "cmd", "_default"):
                d.activate_search(name)
                d.decode_senscr(costs)
                got.append((d.current_search_name(), _hyp(d), _segs(d)))
            out.append(got)
    finally:
        for d in decoders:
            d._searches.pop("cmd", None)
            d.activate_search("_default")
    assert out[1] == out[0]
    assert out[1][0] == out[1][2] and out[1][0][1] != out[1][1][1]
