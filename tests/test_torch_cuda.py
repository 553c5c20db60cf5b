"""Tests of the port that need the card: the CUDA kernels against their
plain versions, and a small decode on CUDA against the same decode on the
CPU.  They skip without CUDA.  This file imports no JAX, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pocketsphinx_tpu_torch.ops import chain, fan, transitions
from pocketsphinx_tpu_torch.testing import synth

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(3, 11, 257, 37), (2, 41, 7, 5),
                                   (8, 41, 20035, 601), (8, 41, 125973, 601)],
                         ids=["ragged", "under_one_block", "20k", "126k"])
@pytest.mark.parametrize("ties", [False, True])
def test_fan_kernel_bit_equal(cuda, shape, ties):
    """Every output of the kernel, at every choice of its plane groups,
    equals the plain version's: the padded carry (pads NEG_INF/0), the
    exit plane written into columns [2, 2 + W) of a wider buffer whose
    other columns keep their values, the exits, and the max of the
    partial maxima."""
    B, NRC, W, LP = shape
    a = chip_smoke.to_device(chip_smoke.fan_inputs(
        np.random.default_rng(1), B, NRC, W, LP, ties), cuda)
    bufs = [torch.full((B, NRC, W + 5), 7.0, device=cuda) for _ in range(2)]
    refs = fan.fan_step_ref(**a, out_f=bufs[1][:, :, 2:W + 2])
    for groups in (None,) + fan.GROUPS:
        bufs[0].fill_(7.0)
        n = fan.launches
        outs = fan.fan_step(**a, out_f=bufs[0][:, :, 2:W + 2], groups=groups)
        assert fan.launches == n + 1
        torch.cuda.synchronize()
        assert bool((outs[0][..., W:] == chip_smoke.NEG_INF).all())
        chip_smoke.compare(outs[:7] + (outs[7].amax(1), bufs[0]),
                           refs[:7] + (refs[7].amax(1), bufs[1]),
                           f"fan groups={groups}")


@pytest.mark.parametrize("NST,has_var", [(3, True), (3, False), (5, True)])
def test_chain_kernel_bit_equal(cuda, NST, has_var):
    a = chip_smoke.chain_inputs(np.random.default_rng(2), 3, NST, 6, 200,
                                4, 37, has_var, True)
    grp, args = chip_smoke.chain_group_args([a], cuda)
    n = chain.launches
    outs = chain.chain_group_step(grp, **args)
    assert chain.launches == n + 1
    torch.cuda.synchronize()
    chip_smoke.compare(outs, chain.chain_group_ref(grp, **args), "chain")


@pytest.mark.parametrize("B", [3, 11])
@pytest.mark.parametrize("NST,with_ci", [(3, True), (3, False), (5, True),
                                         (5, False)])
def test_chain_group_kernel_bit_equal(cuda, NST, with_ci, B):
    """One launch over variant buckets of several depths (and a CI
    bucket) equals the grouped plain version; B=11 runs the kernel's loop
    over batch rows past a block's 8."""
    buckets = [(NST, 5, 70, 4, 9, True), (NST, 16, 40, 3, 7, True),
               (NST, 2, 300, 2, 5, True)]
    if with_ci:
        buckets.append((NST, 4, 9, 0, 0, False))
    rng = np.random.default_rng(3)
    per = [chip_smoke.chain_inputs(rng, B, *bk, True) for bk in buckets]
    grp, args = chip_smoke.chain_group_args(per, cuda)
    n = chain.launches
    outs = chain.chain_group_step(grp, **args)
    assert chain.launches == n + 1
    torch.cuda.synchronize()
    chip_smoke.compare(outs, chain.chain_group_ref(grp, **args),
                       "chain group")


#: the word-transition kernel's cases: (LM mode, dictionary words, topk,
#: FAT_CAP or None, trigram rows in the 2-D tg2c table, trigrams per
#: context at most, extra CI phones); 40 words give E = 108 columns (one
#: ragged tile), 300 give more than one tile at the narrow launch shapes,
#: and topk 10**6 gives K = W, over 128 exits staged at once at 300
#: words; 40 trigrams per context give many (k, e) pairs with both a CSR
#: bigram and a trigram correction; 28 extra phones give a 70-phone model
#: (two accept words per column)
BLOCK_CASES = {"rows": ("rows", 40, 8, None, True, 4, 0),
               "rows_kw": ("rows", 300, 10 ** 6, None, True, 4, 0),
               "sparse": ("sparse", 300, 8, None, True, 4, 0),
               "sparse_flat_kw": ("sparse", 300, 10 ** 6, None, False, 4, 0),
               "csr": ("csr", 300, 40, None, True, 4, 0),
               "csr_fat_flat_kw": ("csr", 40, 10 ** 6, 2, False, 4, 0),
               "csr_tri": ("csr", 300, 40, None, True, 40, 0),
               "sparse_tri_kw": ("sparse", 300, 10 ** 6, None, False, 40, 0),
               "phones_rows_kw": ("rows", 40, 10 ** 6, None, True, 4, 28),
               "phones_csr_kw": ("csr", 300, 10 ** 6, None, True, 40, 28)}


def _block_decoder(tmp_path, monkeypatch, device, mode, n_words, topk,
                   fat_cap, tg2d, max_tri=4, n_extra=0):
    from pocketsphinx_tpu_torch.search.ngram_fused import NgramFusedDecoder
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=n_words, n_single=3, seed=6,
                                   n_extra_phones=n_extra)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=8,
                           max_tri=max_tri)
    spec = synth.make_model([dic], seed=9, n_sen=3 * (42 + n_extra) + 300,
                            n_density=8, n_extra_phones=n_extra)
    monkeypatch.setenv("PS_LM_MODE", mode)
    if mode == "csr":
        monkeypatch.setenv("PS_LM_TABLE_BYTES", "1000")
    if fat_cap is not None:
        monkeypatch.setattr(NgramFusedDecoder, "FAT_CAP", fat_cap)
    if not tg2d:
        monkeypatch.setenv("PS_TG2D_BYTES", "0")
    dec = synth.build_decoder(spec, str(tmp_path), dic, lmf, topk=topk,
                              device=device)
    assert dec.lm_mode == mode
    return dec


@pytest.mark.parametrize("case", list(BLOCK_CASES))
@pytest.mark.parametrize("ties", [False, True])
def test_transitions_kernel_bit_equal(cuda, tmp_path, monkeypatch, case,
                                      ties):
    """All seven outputs of the kernel, at each launch option (columns per
    thread x splits of the exits) and at the default, equal
    `transitions_ref` on a real frame's exits and on the same exits with
    one live exit (`chip_smoke.solo_exits`), or with tied exits
    (`chip_smoke.tie_exits`); over three parts of a "model" group on the
    card, the parts' kernels join to the unsplit one."""
    dec = _block_decoder(tmp_path, monkeypatch, cuda, *BLOCK_CASES[case])
    c = np.random.default_rng(5).uniform(0, 400, (3, 24, dec.am.n_sen))
    c[:, -1] = 1e29                       # the last frame's scores tie
    real = chip_smoke.frame_exits(dec, torch.as_tensor(
        c.astype(np.float32), device=cuda))[0]
    cases = ([chip_smoke.tie_exits(real, np.random.default_rng(1))] if ties
             else [real, chip_smoke.solo_exits(real)])
    options = [(None, None)] + [(cp, ks) for cp in transitions.COLS_PER_THREAD
                                for ks in transitions.K_SPLITS]
    for args in cases:
        ref = transitions.transitions_ref(*args)
        for cols, ks in options:
            n = transitions.launches
            outs = transitions.transitions(*args, cols_per_thread=cols,
                                           k_split=ks)
            assert transitions.launches == n + 1
            torch.cuda.synchronize()
            chip_smoke.compare(outs, ref, f"transitions {case} cols={cols} "
                                          f"ks={ks}")
    args = cases[0]
    ref = transitions.transitions_ref(*args)
    parts = dec.shard(["cuda:0"] * 3).tables["columns"]
    got = [transitions.transitions(tb, *args[1:]) for _, tb in parts]
    for i, r in enumerate(ref):
        assert torch.equal(torch.cat([g[i] for g in got], 1), r), i


def test_decode_phones_cuda_equals_cpu(cuda, tmp_path, monkeypatch):
    """A 70-phone model (two accept words per column) decodes on CUDA:
    records, hypothesis and score equal the same decoder on the CPU, in
    LM modes B and C."""
    for mode in ("sparse", "csr"):
        dec = _block_decoder(tmp_path, monkeypatch, cuda, mode, 40, 8, None,
                             True, 40, 28)
        assert dec.tables["accept_bits"].shape[0] == 2
        costs = np.random.default_rng(5).uniform(0, 400, (50, dec.am.n_sen))
        costs = costs.astype(np.float32)
        n = transitions.launches
        hyp, segs = dec.decode(None, costs=costs)
        assert transitions.launches > n
        cpu = dec.to("cpu")
        hyp_c, segs_c = cpu.decode(None, costs=costs)
        for a, b in zip(dec.raw_records, cpu.raw_records):
            np.testing.assert_array_equal(a, b)
        assert (hyp, dec.hyp_score) == (hyp_c, cpu.hyp_score)


def test_decode_cuda_equals_cpu(cuda, tmp_path):
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=40)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=3)
    spec = synth.make_model([dic], seed=1, n_sen=126 + 300, n_density=8)
    dec = synth.build_decoder(spec, str(tmp_path), dic, lmf, topk=8,
                              device=cuda)
    costs = np.random.default_rng(5).uniform(0, 400, (50, dec.am.n_sen))
    costs = costs.astype(np.float32)
    hyp, segs = dec.decode(None, costs=costs)
    cpu = dec.to("cpu")
    hyp_c, segs_c = cpu.decode(None, costs=costs)
    for a, b in zip(dec.raw_records, cpu.raw_records):
        np.testing.assert_array_equal(a, b)
    assert (hyp, dec.hyp_score) == (hyp_c, cpu.hyp_score)


@pytest.mark.parametrize("fat_cap", [None, 2])
def test_lm_mode_csr_cuda_equals_cpu(cuda, tmp_path, monkeypatch, fat_cap):
    """LM mode C (forced; with FAT_CAP=2 the fat rows too) and
    PS_GUARD_TOPM (mode B): a decode and a B=3 minimal scan on CUDA equal
    the same decoder on the CPU."""
    from pocketsphinx_tpu_torch.search.ngram_fused import NgramFusedDecoder
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, seed=2)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=4)
    spec = synth.make_model([dic], seed=5, n_sen=126 + 300, n_density=8)
    monkeypatch.setenv("PS_LM_TABLE_BYTES", "1000")
    if fat_cap:
        monkeypatch.setattr(NgramFusedDecoder, "FAT_CAP", fat_cap)
    decs = []
    for mode, topm in (("csr", "0"), ("sparse", "4")):
        monkeypatch.setenv("PS_LM_MODE", mode)
        monkeypatch.setenv("PS_GUARD_TOPM", topm)
        decs.append(synth.build_decoder(spec, str(tmp_path), dic, lmf,
                                        topk=8, device=cuda))
    assert decs[0].lm_mode == "csr" and (decs[0].N_FAT > 0) == bool(fat_cap)
    assert decs[1].GM == 4
    rng = np.random.default_rng(7)
    costs = rng.uniform(0, 400, (3, 50, decs[0].am.n_sen)).astype(np.float32)
    costs[:, 20] = 1e29
    valid = np.arange(50)[None, :] < np.array([50, 31, 12])[:, None]
    for dec in decs:
        cpu = dec.to("cpu")
        hyp, _ = dec.decode(None, costs=costs[0])
        assert cpu.decode(None, costs=costs[0])[0] == hyp
        for a, b in zip(dec.raw_records, cpu.raw_records):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(dec.scan(torch.as_tensor(costs, device=cuda),
                                 torch.as_tensor(valid, device=cuda), True),
                        cpu.scan(torch.as_tensor(costs),
                                 torch.as_tensor(valid), True)):
            assert torch.equal(a.cpu(), b)


def test_decode_corpus_cuda(cuda, tmp_path):
    """`BatchDecodePipeline.decode_corpus` on one card equals
    `decode_batch` on the same padded batch, and `TwoStagePipeline` equals
    both; the kernels launch once per frame stepped."""
    from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline, make_mesh
    from pocketsphinx_tpu_torch.parallel.pipeline import TwoStagePipeline
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, seed=1)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=2)
    spec = synth.make_model([dic], seed=3, n_sen=126 + 300, n_density=16)
    dec = synth.build_decoder(spec, str(tmp_path), dic, lmf, topk=16,
                              device=cuda)
    fe = chip_smoke.en_us_frontend()
    pcms = [synth.make_pcm(60 + i, s) for i, s in enumerate((1.2, 0.9, 1.1))]
    n = fan.launches
    got = chip_smoke._results(BatchDecodePipeline(
        dec, fe, mesh=make_mesh(n_data=1)).decode_corpus(pcms, batch_size=4))
    pcm, ns = chip_smoke.pcm_batch([60, 61, 62], [1.2, 0.9, 1.1])
    T = fe.n_frames(int(ns.max()))
    assert fan.launches - n == -(-T // dec.CHUNK) * dec.CHUNK
    feats, nf = chip_smoke.features(fe, pcm, ns, cuda)
    want = chip_smoke._results(dec.decode_batch(feats, nf,
                                                keep_records=False))
    assert got == want and any(h for h, _ in got)
    assert chip_smoke._results(TwoStagePipeline(dec, fe).decode_corpus(
        pcms)) == got


def test_decode_corpus_cards(cuda, tmp_path):
    """With two or more cards: `decode_corpus` over every card (a replica
    on each, its rows in a thread of its own) and `TwoStagePipeline`
    across the first two cards equal one card's `decode_corpus`."""
    from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline, make_mesh
    from pocketsphinx_tpu_torch.parallel.pipeline import TwoStagePipeline
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two CUDA cards")
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, seed=1)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=2)
    spec = synth.make_model([dic], seed=3, n_sen=126 + 300, n_density=16)
    dec = synth.build_decoder(spec, str(tmp_path), dic, lmf, topk=16,
                              device=cuda)
    fe = chip_smoke.en_us_frontend()
    pcms = [synth.make_pcm(70 + i, 0.8 + 0.1 * (i % 5))
            for i in range(4 * n_cards + 1)]
    one = chip_smoke._results(BatchDecodePipeline(
        dec, fe, mesh=make_mesh(n_data=1)).decode_corpus(pcms, batch_size=4))
    pipe = BatchDecodePipeline(dec, fe)
    assert pipe.data_parallelism == n_cards
    assert {r.device.index for r in pipe.replicas} == set(range(n_cards))
    # four rows per card: the one-card run's batches, so the same GEMM shapes
    assert chip_smoke._results(pipe.decode_corpus(
        pcms, batch_size=4 * n_cards)) == one
    two = TwoStagePipeline(dec, fe)
    assert (two.dev_score.index, two.dev_scan.index) == (0, 1)
    assert chip_smoke._results(two.decode_corpus(pcms, micro_batch=4)) == one
    assert any(h for h, _ in one)


def test_decode_corpus_current_card(cuda, tmp_path):
    """With two or more cards: a decoder built with card 1 current lives on
    card 1 and stays there once card 0 is current again; its
    `decode_corpus` on card 1 equals the one-card result on card 0."""
    from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline, make_mesh
    from pocketsphinx_tpu_torch.parallel.batch import Mesh
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, seed=1)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=2)
    spec = synth.make_model([dic], seed=3, n_sen=126 + 300, n_density=16)
    dec0 = synth.build_decoder(spec, str(tmp_path), dic, lmf, topk=16,
                               device="cuda:0")
    with torch.cuda.device(1):
        dec1 = synth.build_decoder(spec, str(tmp_path), dic, lmf, topk=16)
    assert dec1.device == torch.device("cuda", 1)
    fe = chip_smoke.en_us_frontend()
    pcms = [synth.make_pcm(80 + i, 0.8 + 0.1 * i) for i in range(5)]
    one = chip_smoke._results(BatchDecodePipeline(
        dec0, fe, mesh=make_mesh(n_data=1)).decode_corpus(pcms, batch_size=4))
    pipe = BatchDecodePipeline(dec1, fe, mesh=Mesh([["cuda:1"]]))
    assert pipe.replicas[0] is dec1
    assert chip_smoke._results(pipe.decode_corpus(pcms, batch_size=4)) == one
    assert any(h for h, _ in one)


def _tp_decoders(tmp_path, monkeypatch, device):
    """A small decoder on `device` in LM modes B and C (C with fat rows):
    {mode: decoder}."""
    from pocketsphinx_tpu_torch.search.ngram_fused import NgramFusedDecoder
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, seed=2)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=4)
    spec = synth.make_model([dic], seed=5, n_sen=126 + 300, n_density=8)
    monkeypatch.setenv("PS_LM_TABLE_BYTES", "1000")
    monkeypatch.setattr(NgramFusedDecoder, "FAT_CAP", 2)
    out = {}
    for mode in ("sparse", "csr"):
        monkeypatch.setenv("PS_LM_MODE", mode)
        out[mode] = synth.build_decoder(spec, str(tmp_path), dic, lmf,
                                        topk=8, device=device)
        assert out[mode].lm_mode == mode
    return out


def _tp_equal(dec, group):
    """`dec.shard(group)` equals `dec` on one B=3 cost matrix: full and
    minimal records (nviol among them), hypotheses, scores, guard counts;
    the kernels launch once per frame, on the lead."""
    sp = dec.shard(group)
    assert sp.device == dec.device and len(sp.tables["columns"]) == 2
    rng = np.random.default_rng(7)
    costs = rng.uniform(0, 400, (3, 50, dec.am.n_sen)).astype(np.float32)
    costs[:, 20] = 1e29
    costs = torch.as_tensor(costs, device=dec.device)
    nf = np.array([50, 31, 12])
    valid = torch.as_tensor(np.arange(50)[None, :] < nf[:, None],
                            device=dec.device)
    for minimal in (False, True):
        n = (fan.launches, chain.launches, transitions.launches)
        got = sp.scan(costs, valid, minimal)
        assert (fan.launches - n[0], chain.launches - n[1],
                transitions.launches - n[2]) == (64, 64, 128)
        for a, b in zip(got, dec.scan(costs, valid, minimal)):
            assert a.device == dec.device and torch.equal(a, b)
    want = chip_smoke._results(dec.decode_batch(None, nf, False, costs))
    assert chip_smoke._results(sp.decode_batch(None, nf, False, costs)) == \
        want
    assert sp.hyp_scores == dec.hyp_scores and any(h for h, _ in want)
    assert sp.guard_violations_batch == dec.guard_violations_batch


def test_tp_one_card_equals_unsplit(cuda, tmp_path, monkeypatch):
    """Two model parts on one card (LM modes B and C) equal the unsplit
    decoder."""
    for dec in _tp_decoders(tmp_path, monkeypatch, cuda).values():
        _tp_equal(dec, ["cuda:0", "cuda:0"])


def test_tp_split_scoring_cuda(cuda, tmp_path):
    """The scoring split over codebooks (tp=2) and over senone slots (a tp
    that does not divide CB) stays within the scoring tolerance of the
    unsplit scoring on the card."""
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores
    dic = str(tmp_path / "small.dic")
    synth.small_dictionary(dic, n_words=40, seed=2)
    am, _ = synth.make_model([dic], seed=5, n_sen=126 + 300,
                             n_density=8).load(str(tmp_path / "model"))
    CB = am.scoring_arrays["prec"].shape[0]
    F, L = am.scoring_arrays["prec"].shape[1::2]
    feats = torch.as_tensor(np.random.default_rng(3).normal(
        0, 2, (2, 21, F, L)).astype(np.float32), device=cuda)
    whole = senone_scores(am.scoring_tensors(cuda), feats, time_chunk=16)
    for tp in (2, next(k for k in range(2, CB) if CB % k)):
        got = senone_scores(am.scoring_shards(["cuda:0"] * tp), feats,
                            time_chunk=16)
        assert got.device == whole.device
        torch.testing.assert_close(got, whole, atol=2e-2, rtol=1e-5)


def test_tp_two_cards(cuda, tmp_path, monkeypatch):
    """With two or more cards: the model parts on cards 0 and 1 (modes B
    and C) equal the unsplit decoder on card 0, and the split scoring
    stays within the tolerance."""
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    for dec in _tp_decoders(tmp_path, monkeypatch, "cuda:0").values():
        _tp_equal(dec, ["cuda:0", "cuda:1"])
    F, L = dec.am.scoring_arrays["prec"].shape[1::2]
    feats = torch.as_tensor(np.random.default_rng(3).normal(
        0, 2, (2, 21, F, L)).astype(np.float32), device="cuda:0")
    got = senone_scores(dec.shard(["cuda:0", "cuda:1"]).scoring(), feats)
    torch.testing.assert_close(
        got, senone_scores(dec.am.scoring_tensors("cuda:0"), feats),
        atol=2e-2, rtol=1e-5)


def _tp_graph_equal(dec, group):
    """`dec.shard(group)` on one B=8 cost matrix of unequal lengths,
    minimal and full records: through its CUDA graph (the default, one
    graph over the group's cards), stepped eagerly and unsplit, records
    and carries equal; each run launches the fan and the chain once per
    frame and the transition kernel once per frame and part."""
    sp = dec.shard(group)
    tp = len(group)
    costs, nf = _graph_costs(dec, [50, 33, 17, 50, 41, 9, 26, 48], 31)
    valid = np.arange(costs.shape[1])[None, :] < nf[:, None]
    c, v = (torch.as_tensor(x, device=dec.device) for x in (costs, valid))
    frames = -(-costs.shape[1] // dec.CHUNK) * dec.CHUNK
    for minimal in (True, False):
        runs = []
        for d, graph in ((sp, None), (sp, True), (sp, False), (dec, None)):
            before = [m.launches for m in (fan, chain, transitions)]
            runs.append(d._scan(c, v, minimal, graph=graph))
            for k in group:
                torch.cuda.synchronize(k)
            assert [m.launches - n for m, n in zip(
                (fan, chain, transitions), before)] == [
                    frames, frames, frames * (tp if d is sp else 1)]
        run = sp._graphs["runs"][minimal, False]
        assert run.graph is not None and run.launches == dict(
            fan=dec.CHUNK, chain=dec.CHUNK, transitions=dec.CHUNK * tp)
        (rg, cg) = runs[0]
        for r, k in runs[1:]:
            for a, b in zip(rg, r, strict=True):
                assert a.device == dec.device and torch.equal(a, b)
            assert _carry_equal(dec, cg, k)
    want = chip_smoke._results(dec.decode_batch(None, nf, False, c))
    assert chip_smoke._results(sp.decode_batch(None, nf, False, c)) == want
    assert sp.hyp_scores == dec.hyp_scores and any(h for h, _ in want)
    assert sp.guard_violations_batch == dec.guard_violations_batch


@pytest.mark.parametrize("tp", [2, 3])
def test_tp_graph_one_card(cuda, tmp_path, monkeypatch, tp):
    """`tp` model parts on one card (LM modes B and C) through the graph
    equal their eager step and the unsplit decoder."""
    for dec in _tp_decoders(tmp_path, monkeypatch, cuda).values():
        _tp_graph_equal(dec, ["cuda:0"] * tp)


def test_tp_graph_two_cards(cuda, tmp_path, monkeypatch):
    """With two or more cards: the parts on cards 0 and 1, and three parts
    on cards 0, 1 and 0 (LM modes B and C), through one graph over both
    cards equal their eager step and the unsplit decoder on card 0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    for dec in _tp_decoders(tmp_path, monkeypatch, "cuda:0").values():
        for group in (["cuda:0", "cuda:1"], ["cuda:0", "cuda:1", "cuda:0"]):
            _tp_graph_equal(dec, group)


def test_tp_replicas_one_card(cuda, tmp_path):
    """Two split replicas on one card (`Mesh([[card, card], [card,
    card]])`): their rows run in two threads whose first scans capture
    at once; the results equal one split replica's, each replica's
    graph counts its own launches (a chunk's fan and chain, and its
    transitions on both parts), and the counters add one launch per
    frame either replica stepped (two transition launches)."""
    from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline
    from pocketsphinx_tpu_torch.parallel.batch import Mesh
    dec = _graph_decoder(tmp_path, cuda, seed=11)
    fe = chip_smoke.en_us_frontend()
    secs = (1.2, 0.9, 1.1, 0.7, 1.0, 0.8)
    pcms = [synth.make_pcm(90 + i, s) for i, s in enumerate(secs)]
    order = sorted(range(len(pcms)), key=lambda i: len(pcms[i]))
    frames = sum(-(-fe.n_frames(max(len(pcms[i]) for i in rows))
                   // dec.CHUNK) * dec.CHUNK
                 for rows in np.array_split(np.array(order), 2))
    one = chip_smoke._results(BatchDecodePipeline(
        dec, fe, mesh=Mesh([[cuda, cuda]])).decode_corpus(pcms,
                                                         batch_size=3))
    pipe = BatchDecodePipeline(dec, fe, mesh=Mesh([[cuda, cuda]] * 2))
    before = [m.launches for m in (fan, chain, transitions)]
    got = chip_smoke._results(pipe.decode_corpus(pcms, batch_size=6))
    torch.cuda.synchronize()
    assert [m.launches - n for m, n in zip(
        (fan, chain, transitions), before)] == [frames, frames, 2 * frames]
    assert got == one and any(h for h, _ in one)
    assert pipe.replicas[0] is not pipe.replicas[1]
    for r in pipe.replicas:
        assert len(r.tables["columns"]) == 2
        assert r._graphs["runs"][True, False].launches == dict(
            fan=dec.CHUNK, chain=dec.CHUNK, transitions=2 * dec.CHUNK)


def test_flat_cuda_equals_cpu(cuda, tmp_path):
    """The flat search on CUDA: a decode and a B=3 batch of unequal
    lengths give the CPU's records, hypotheses and segments."""
    from pocketsphinx_tpu_torch import Decoder
    from pocketsphinx_tpu_torch.lm.ngram import read_lm
    from pocketsphinx_tpu_torch.search.ngram_flat import NgramFlatDecoder
    hmm, dic, lmf = synth.small_task(str(tmp_path), seed=7)
    d = Decoder(hmm=hmm, dict=dic, device="cpu")
    cpu = NgramFlatDecoder(d.am, d.d2p, read_lm(lmf, lw=6.5, wip=0.65),
                           device="cpu")
    dev = cpu.to(cuda)
    rng = np.random.default_rng(31)
    costs = rng.uniform(0, 400, (3, 60, d.am.n_sen)).astype(np.float32)
    costs[:, 25] = 200.0
    nf = [60, 41, 17]
    key = lambda s: [(x.word, x.start, x.end) for x in s]  # noqa: E731
    one = [f.decode(None, costs=costs[0]) for f in (dev, cpu)]
    assert one[0][0] == one[1][0] and key(one[0][1]) == key(one[1][1])
    for a, b in zip(dev.records, cpu.records):
        np.testing.assert_array_equal(a, b)
    outs = [f.decode_batch(None, nf, costs=costs) for f in (dev, cpu)]
    for b, n in enumerate(nf):
        assert outs[0][b][0] == outs[1][b][0]
        assert key(outs[0][b][1]) == key(outs[1][b][1])
        for x, y in zip(dev.batch_records[b], cpu.batch_records[b]):
            np.testing.assert_array_equal(x[:n], y[:n])
    assert one[0][0]


def test_cli_single_cuda_equals_cpu(cuda, tmp_path, capsys):
    """`cli.main(["single", ...])` on CUDA, by default and asked for,
    prints the CPU's JSON line, and the kernels launch."""
    from pocketsphinx_tpu_torch import cli
    hmm, dic, lmf = synth.small_task(str(tmp_path), seed=7)
    wav = chip_smoke._write_wav(str(tmp_path / "a.wav"),
                                synth.make_pcm(41, 1.5))
    argv = ["-hmm", hmm, "-dict", dic, "-lm", lmf, "single", wav]
    out = []
    for device in ("cpu", None, cuda):
        n = fan.launches
        assert cli.main(argv, device=device) == 0
        out.append(capsys.readouterr().out)
        assert (fan.launches > n) == (device != "cpu")
    assert out[0] == out[1] == out[2] and '"t": ' in out[0]


def _row_carry(dec, carry, B, b):
    ch, ci = dec._chain_views(carry["chain"], B)
    return ([e[k][b].cpu() for e in ch + ci for k in sorted(e)]
            + [carry[n][k][b].cpu() for n in ("fin", "sp")
               if carry[n] is not None for k in ("S", "TF", "CTX")])


def test_with_carry_batch_rows_cuda(cuda, tmp_path):
    """The masked streaming scan at B=2 on CUDA, the rows' valid lengths
    differing inside the middle block (96 and 48 frames): each row's
    records and carry equal its own whole scan on CUDA, and records and
    carry equal the same blocks on the CPU."""
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, seed=4)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=5)
    spec = synth.make_model([dic], seed=6, n_sen=126 + 300, n_density=8)
    dec = synth.build_decoder(spec, str(tmp_path), dic, lmf, topk=8,
                              device=cuda)
    cpu = dec.to("cpu")
    T, BL, lens = 96, 32, (96, 48)
    costs = np.random.default_rng(12).uniform(
        0, 400, (2, T, dec.am.n_sen)).astype(np.float32)
    costs[0, 40:46] = 1e29
    valid = np.arange(T)[None, :] < np.array(lens)[:, None]
    runs = []
    for d in (dec, cpu):
        carry, got = None, []
        for b0 in range(0, T, BL):
            recs, carry = d.with_carry(
                torch.as_tensor(costs[:, b0:b0 + BL], device=d.device),
                torch.as_tensor(valid[:, b0:b0 + BL], device=d.device),
                carry, b0)
            got.append([r.cpu() for r in recs])
        runs.append(([torch.cat([g[k] for g in got], 1) for k in range(10)],
                     carry))
    (recs, carry), (recs_c, carry_c) = runs
    for a, b in zip(recs, recs_c):
        assert torch.equal(a, b)
    for b, n in enumerate(lens):
        assert all(torch.equal(x, y) for x, y in zip(
            _row_carry(dec, carry, 2, b), _row_carry(cpu, carry_c, 2, b)))
        whole, wcarry = dec._scan(
            torch.as_tensor(costs[b:b + 1, :n], device=cuda),
            torch.ones((1, n), dtype=torch.bool, device=cuda), False)
        for k in range(10):
            assert torch.equal(recs[k][b, :n], whole[k][0].cpu())
        assert all(torch.equal(x, y) for x, y in zip(
            _row_carry(dec, carry, 2, b), _row_carry(dec, wcarry, 1, 0)))


def _facade(cuda, tmp_path):
    from pocketsphinx_tpu_torch import Decoder
    hmm, dic, lmf = synth.small_task(str(tmp_path), seed=7)
    dec = Decoder(hmm=hmm, dict=dic, lm=lmf, device=cuda)
    return dec, dec._to("cpu")


def _result(d):
    from dataclasses import astuple
    lat = d.get_lattice()
    return (astuple(d.hyp()),
            [(s.word, s.start_frame, s.end_frame, s.prob, s.ascore)
             for s in d.seg_iter()],
            [(n.word, n.sf) for n in lat.nodes],
            [(l.src, l.dst, l.ef, l.ascr) for l in lat.links])


def test_decoder_cuda_equals_cpu(cuda, tmp_path):
    """`decode_senscr` through the facade: records, lattice lists and the
    best-path result on CUDA equal the same decoder on the CPU."""
    dec, cpu = _facade(cuda, tmp_path)
    costs = np.random.default_rng(11).uniform(
        0, 400, (96, dec.am.n_sen)).astype(np.float32)
    n = fan.launches
    for d in (dec, cpu):
        d.decode_senscr(costs)
    assert fan.launches == n + 96
    for a, b in zip(dec._searches["_default"].raw_records,
                    cpu._searches["_default"].raw_records):
        np.testing.assert_array_equal(a, b)
    assert _result(dec) == _result(cpu)
    assert dec.hyp().hypstr


def test_decoder_streaming_cuda_equals_cpu(cuda, tmp_path):
    """Streaming through the facade on CUDA (masked carry, padded last
    block) equals the CPU, both scanning the CPU's senone costs."""
    dec, cpu = _facade(cuda, tmp_path)
    score = cpu._scores
    pcm = synth.make_pcm(33, 2.2)
    out = []
    for d in (dec, cpu):
        d._scores = lambda feats, d=d, **kw: score(feats, **kw).to(d.device)
        d.start_utt()
        parts = []
        for c0 in range(0, len(pcm), 1600):
            d.process_raw(pcm[c0:c0 + 1600])
            parts.append(d.partial_hyp())
        d.end_utt()
        recs = [np.concatenate([r[k] for r in d._stream_recs])
                for k in range(10)]
        out.append((recs, [p and p.hypstr for p in parts], _result(d)))
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)
    assert out[0][1:] == out[1][1:]
    assert dec.n_frames % 32 != 0           # a padded, masked last block


@pytest.mark.parametrize("mode", ["jsgf", "kws", "allphone", "allphone_tri",
                                  "align"])
def test_modes_cuda_equal_cpu(cuda, tmp_path, mode):
    """Each grammar / keyword / allphone / align search decodes the same
    costs to the same result on CUDA as on the CPU, records included."""
    dec = chip_smoke.mode_decoder(str(tmp_path), cuda)
    name = chip_smoke.add_mode(dec, mode, str(tmp_path))
    cpu = dec._to("cpu")
    costs = np.random.default_rng(26).uniform(
        0, 400, (90, dec.am.n_sen)).astype(np.float32)
    costs[30] = 200.0
    for d in (dec, cpu):
        d.activate_search(name)
        d.decode_senscr(costs)
    assert chip_smoke.mode_result(dec) == chip_smoke.mode_result(cpu)
    chip_smoke.check_records(dec._searches[name], cpu._searches[name], mode)
    assert dec.hyp().hypstr or mode == "kws"


def test_nst5_decode_cuda(cuda, tmp_path):
    """A 5-state model through the facade on CUDA: the chain kernel
    launches once per scanned frame, the fan kernel never, and the
    records equal the CPU's."""
    from pocketsphinx_tpu_torch import Decoder
    hmm, dic, lmf = synth.small_task(str(tmp_path), seed=9,
                                     n_sen=210 + 400, n_state=5)
    dec = Decoder(hmm=hmm, dict=dic, lm=lmf, device=cuda)
    costs = np.random.default_rng(27).uniform(
        0, 400, (70, dec.am.n_sen)).astype(np.float32)
    nf, nc = fan.launches, chain.launches
    dec.decode_senscr(costs)
    search = dec._searches["_default"]
    assert search.NST == 5
    assert (fan.launches - nf, chain.launches - nc) == \
        (0, -(-70 // search.CHUNK) * search.CHUNK)
    cpu = dec._to("cpu")
    cpu.decode_senscr(costs)
    for a, b in zip(search.raw_records, cpu._searches["_default"].raw_records):
        np.testing.assert_array_equal(a, b)
    assert _result(dec) == _result(cpu)


# -- the scan's CUDA graph (`_ScanGraph`) ------------------------------------

def _graph_decoder(tmp_path, cuda, seed=1):
    tmp_path.mkdir(parents=True, exist_ok=True)
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, seed=seed)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=seed + 2)
    spec = synth.make_model([dic], seed=seed + 4, n_sen=126 + 300,
                            n_density=8)
    return synth.build_decoder(spec, str(tmp_path), dic, lmf, topk=8,
                               device=cuda)


def _graph_costs(dec, lens, seed):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0, 400, (len(lens), max(lens), dec.am.n_sen))
    costs = costs.astype(np.float32)
    costs[:, max(lens) // 3] = 1e29                  # a frame of ties
    return costs, np.asarray(lens)


def _carry_equal(dec, a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for (_, x), (_, y) in zip(
        dec._carry_fields(a), dec._carry_fields(b), strict=True))


def test_decode_batch_graph_equals_eager_and_cpu(cuda, tmp_path):
    """B=8 with unequal lengths, minimal and full records: the scan
    through the graph (the default) equals the eager step on the card and
    the CPU, records and carry; `decode_batch`'s hypotheses, segments,
    scores and guard counts too."""
    dec = _graph_decoder(tmp_path, cuda)
    cpu = dec.to("cpu")
    costs, nf = _graph_costs(dec, [50, 33, 17, 50, 41, 9, 26, 48], 21)
    valid = np.arange(costs.shape[1])[None, :] < nf[:, None]
    c, v = (torch.as_tensor(x, device=cuda) for x in (costs, valid))
    for minimal in (True, False):
        rg, cg = dec._scan(c, v, minimal)
        assert dec._graphs["runs"][minimal, False].graph is not None
        re, ce = dec._scan(c, v, minimal, graph=False)
        rc, cc = cpu._scan(torch.as_tensor(costs), torch.as_tensor(valid),
                           minimal)
        for a, b, r in zip(rg, re, rc, strict=True):
            assert torch.equal(a, b) and torch.equal(a.cpu(), r)
        assert _carry_equal(dec, cg, ce) and _carry_equal(dec, cg, cc)
        outs = []
        for d, kw in ((dec, {}), (dec, {"graph": False}), (cpu, {})):
            out = d.decode_batch(None, nf, keep_records=not minimal,
                                 costs=torch.as_tensor(costs,
                                                       device=d.device),
                                 **kw)
            outs.append((chip_smoke._results(out), d.hyp_scores,
                         d.guard_violations_batch))
        assert outs[0] == outs[1] == outs[2]
        assert any(h for h, _ in outs[0][0])


def test_stream_graph_equals_eager(cuda, tmp_path):
    """The `Decoder` stream (0.1 s chunks, a padded and masked last block)
    through the graph equals the same stream stepped eagerly
    (`Decoder._to(..., graph=False)`); `with_carry` resumed at t0 = 37 from
    a carry gives the same records and carry either way, and a carry it
    returned stays as it was through later calls."""
    dec, _ = _facade(cuda, tmp_path)
    eager = dec._to(cuda, graph=False)
    search = dec._searches["_default"]
    assert search.graph and not eager._searches["_default"].graph
    pcm = synth.make_pcm(34, 2.3)
    out = []
    for d in (dec, eager):
        d.start_utt()
        parts = []
        for c0 in range(0, len(pcm), 1600):
            d.process_raw(pcm[c0:c0 + 1600])
            parts.append(d.partial_hyp())
        d.end_utt()
        recs = [np.concatenate([r[k] for r in d._stream_recs])
                for k in range(10)]
        out.append((recs, [p and p.hypstr for p in parts], _result(d)))
    for a, b in zip(out[0][0], out[1][0], strict=True):
        np.testing.assert_array_equal(a, b)
    assert out[0][1:] == out[1][1:]
    costs, _ = _graph_costs(search, [80], 22)
    c = torch.as_tensor(costs, device=cuda)
    one = torch.ones((1, 80), dtype=torch.bool, device=cuda)
    runs = []
    for g in (True, False):
        r1, k1 = search.with_carry(c[:, :37], one[:, :37], graph=g)
        kept = [x.clone() for _, x in search._carry_fields(k1)]
        r2, k2 = search.with_carry(c[:, 37:], one[:, 37:], k1, 37, graph=g)
        search.with_carry(c[:, 5:40], one[:, 5:40], graph=g)
        assert all(torch.equal(x, y) for (_, x), y in zip(
            search._carry_fields(k1), kept, strict=True))
        runs.append((r1, r2, k2))
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1],
                    strict=True):
        assert torch.equal(a, b)
    assert _carry_equal(search, runs[0][2], runs[1][2])


def test_graph_launch_counts(cuda, tmp_path):
    """Each kernel's counter adds one launch per frame stepped through
    graph replays: the first scan (which captures) and the later ones,
    as through the eager step."""
    dec = _graph_decoder(tmp_path, cuda, seed=3)
    costs, nf = _graph_costs(dec, [40, 21, 7], 23)
    valid = np.arange(costs.shape[1])[None, :] < nf[:, None]
    c, v = (torch.as_tensor(x, device=cuda) for x in (costs, valid))
    frames = -(-costs.shape[1] // dec.CHUNK) * dec.CHUNK
    for graph in (True, True, False):
        before = [m.launches for m in (fan, chain, transitions)]
        dec.scan(c, v, True, graph=graph)
        torch.cuda.synchronize()
        assert [m.launches - n for m, n in zip(
            (fan, chain, transitions), before)] == [frames] * 3
    run = dec._graphs["runs"][True, False]
    assert run.launches == dict.fromkeys(("chain", "fan", "transitions"),
                                         dec.CHUNK)


def test_graph_two_batch_sizes(cuda, tmp_path):
    """Two batch sizes on one decoder, interleaved, each get a graph of
    their own and stay equal to the eager step; the decoder keeps the
    graphs of the last one only (one static carry)."""
    dec = _graph_decoder(tmp_path, cuda, seed=5)
    inputs = {}
    for B, lens in ((3, [40, 21, 33]), (5, [19, 40, 8, 27, 36])):
        costs, nf = _graph_costs(dec, lens, 24 + B)
        valid = np.arange(costs.shape[1])[None, :] < nf[:, None]
        inputs[B] = [torch.as_tensor(x, device=cuda) for x in (costs, valid)]
    want = {B: dec.scan(*x, True, graph=False) for B, x in inputs.items()}
    seen = []
    for B in (3, 5, 3, 5):
        for a, b in zip(dec.scan(*inputs[B], True), want[B], strict=True):
            assert torch.equal(a, b)
        assert dec._graphs["shape"] == (B, dec.am.n_sen)
        assert set(dec._graphs["runs"]) == {(True, False)}
        run = dec._graphs["runs"][True, False]
        assert run.graph is not None and run.io.costs.shape[0] == B
        seen.append(run)
    assert len({id(r) for r in seen}) == 4


def test_decode_corpus_two_replicas_one_card(cuda, tmp_path):
    """Two replicas on one card (`Mesh([[card], [card]])`): their rows
    run in two threads whose first scans capture at once; the results
    equal one replica's, and each kernel counts one launch per frame
    either replica stepped."""
    from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline, make_mesh
    from pocketsphinx_tpu_torch.parallel.batch import Mesh
    dec = _graph_decoder(tmp_path, cuda, seed=9)
    fe = chip_smoke.en_us_frontend()
    secs = (1.2, 0.9, 1.1, 0.7, 1.0, 0.8)
    pcms = [synth.make_pcm(80 + i, s) for i, s in enumerate(secs)]
    order = sorted(range(len(pcms)), key=lambda i: len(pcms[i]))
    frames = sum(-(-fe.n_frames(max(len(pcms[i]) for i in rows))
                   // dec.CHUNK) * dec.CHUNK
                 for rows in np.array_split(np.array(order), 2))
    runs = []
    # one replica (a twin) in batches of 3, then two on `dec` (unscanned)
    # taking 3 rows each of one batch of 6: the same rows per scan, so
    # the same GEMM shapes
    for search, mesh, B in ((dec.to(cuda), make_mesh(n_data=1), 3),
                            (dec, Mesh([[cuda], [cuda]]), 6)):
        pipe = BatchDecodePipeline(search, fe, mesh=mesh)
        before = [m.launches for m in (fan, chain, transitions)]
        got = chip_smoke._results(pipe.decode_corpus(pcms, batch_size=B))
        torch.cuda.synchronize()
        assert [m.launches - n for m, n in zip(
            (fan, chain, transitions), before)] == [frames] * 3
        runs.append(got)
    assert pipe.replicas[0] is not pipe.replicas[1]
    assert runs[0] == runs[1] and any(h for h, _ in runs[0])
    for r in pipe.replicas:
        assert r._graphs["runs"][True, False].graph is not None


def test_graph_capture_with_garbage(cuda, tmp_path):
    """A capture while the garbage collector runs at every allocation and
    an unreachable cycle holds another decoder and its captured graph:
    collecting it during the capture would destroy that graph, a call
    that invalidates the capture. The capture must succeed and replay
    equal to the eager step."""
    import gc
    old = _graph_decoder(tmp_path / "old", cuda, seed=7)
    costs, nf = _graph_costs(old, [40, 21, 33], 28)
    valid = np.arange(costs.shape[1])[None, :] < nf[:, None]
    c, v = (torch.as_tensor(x, device=cuda) for x in (costs, valid))
    old.scan(c, v, True)
    assert old._graphs["runs"][True, False].graph is not None
    old.cycle = old
    del old
    dec = _graph_decoder(tmp_path / "new", cuda, seed=7)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        got = dec.scan(c, v, True)
    finally:
        gc.set_threshold(*thresholds)
    for a, b in zip(got, dec.scan(c, v, True, graph=False), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(8, 499, 25), (3, 37, 40), (2, 1, 25),
                                   (5, 9, 7)],
                         ids=["main_path", "ragged", "one_frame", "narrow"])
def test_denoise_kernel_bit_equal(cuda, shape):
    """The gains kernel equals its plain version on the card bit for bit,
    frames past each length (zero power) included, one launch a call."""
    from pocketsphinx_tpu_torch.ops import denoise
    x = chip_smoke.denoise_inputs(np.random.default_rng(5), *shape)
    x = torch.as_tensor(x, device=cuda)
    n = denoise.launches
    got = denoise.gains(x)
    assert denoise.launches == n + 1
    torch.cuda.synchronize()
    chip_smoke.compare((got,), (denoise.gains_ref(x),), "denoise")


def test_frontend_denoise_launches(cuda):
    """`process_batch` with noise removal launches the gains kernel once
    per batch, and its cepstra agree with the CPU's."""
    from pocketsphinx_tpu_torch.ops import denoise
    fe = chip_smoke.en_us_frontend()
    pcm, ns = chip_smoke.pcm_batch([1, 2, 3], [1.0, 0.6, 0.8])
    n = denoise.launches
    cep, nf = fe.process_batch(torch.as_tensor(pcm, device=cuda), ns)
    assert denoise.launches == n + 1
    cep_c, nf_c = fe.process_batch(pcm, ns, device="cpu")
    assert torch.equal(nf.cpu(), nf_c)
    for b, k in enumerate(nf_c.tolist()):
        np.testing.assert_allclose(cep[b, :k].cpu().numpy(),
                                   cep_c[b, :k].numpy(), atol=2e-3, rtol=0)


@pytest.mark.parametrize("mode", ["jsgf", "kws", "allphone", "allphone_tri",
                                  "align"])
def test_mode_graph_equals_eager(cuda, tmp_path, mode):
    """Each grammar / keyword / allphone / align search on the card steps
    its whole chunks through a captured CUDA graph, kept across
    utterances (the aligner's per `align`), and gives the records and
    results of its eager twin (`Decoder._to(..., graph=False)`)."""
    dec = chip_smoke.mode_decoder(str(tmp_path), cuda)
    name = chip_smoke.add_mode(dec, mode, str(tmp_path))
    eager = dec._to(cuda, graph=False)
    rng = np.random.default_rng(27)
    runner = None
    for T in (90, 11, 48):
        costs = rng.uniform(0, 400, (T, dec.am.n_sen)).astype(np.float32)
        costs[T // 3] = 200.0
        for d in (dec, eager):
            d.activate_search(name)
            d.decode_senscr(costs)
        assert chip_smoke.mode_result(dec) == chip_smoke.mode_result(eager)
        chip_smoke.check_records(dec._searches[name], eager._searches[name],
                                 mode)
        g = dec._searches[name].chunk_graph
        assert eager._searches[name].chunk_graph is None
        if T >= 16:
            assert g.graph is not None and g.capture_s > 0
        if mode != "align" and runner is not None and T >= 16:
            assert g is runner
        runner = g if T >= 16 else runner


def test_flat_graph_equals_eager_cuda(cuda, tmp_path):
    """The flat search's scan through its captured graph equals the eager
    step on the card, records and carry, at B=4 with unequal lengths."""
    from pocketsphinx_tpu_torch import Decoder
    from pocketsphinx_tpu_torch.lm.ngram import read_lm
    from pocketsphinx_tpu_torch.search.ngram_flat import NgramFlatDecoder
    hmm, dic, lmf = synth.small_task(str(tmp_path), seed=7)
    d = Decoder(hmm=hmm, dict=dic, device="cpu")
    flat = NgramFlatDecoder(d.am, d.d2p, read_lm(lmf, lw=6.5, wip=0.65),
                            device=cuda)
    rng = np.random.default_rng(32)
    lens = torch.tensor([45, 30, 7, 45], device=cuda)
    costs = torch.as_tensor(rng.uniform(0, 400, (4, 45, d.am.n_sen)),
                            dtype=torch.float32, device=cuda)
    valid = torch.arange(45, device=cuda)[None] < lens[:, None]
    rg, cg = flat.with_carry(costs, valid)
    assert flat.chunk_graph.graph is not None
    re_, ce = flat.with_carry(costs, valid, graph=False)
    for a, b in zip(rg, re_):
        assert torch.equal(a, b)
    for a, b in zip(cg, ce):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_capture_seconds_and_spans_on_the_card(cuda):
    """A graph capture adds its seconds to the program's "capture_s"
    counter (the runner's `capture_s` is that measurement); replays
    under the profiler record their "ps." spans, whose device-side
    annotations are user annotations, not device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from pocketsphinx_tpu_torch import profile
    from pocketsphinx_tpu_torch.search.base import CHUNK, ChunkGraph
    T = 2 * CHUNK + 5
    xs = (torch.arange(T, dtype=torch.float32, device=cuda)[:, None]
          .repeat(1, 3),)

    def step(carry, x, t):
        carry = carry * 0.5 + x
        return carry, (carry,)
    run = ChunkGraph(cuda, key=None)
    before = profile.counters().get("capture_s", 0.0)
    first, _ = run.run(step, torch.zeros(3, device=cuda), xs, T)
    assert run.graph is not None and run.capture_s > 0
    assert profile.counters()["capture_s"] - before == pytest.approx(
        run.capture_s)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        again, _ = run.run(step, torch.zeros(3, device=cuda), xs, T)
        torch.cuda.synchronize()
    assert profile.counters()["capture_s"] - before == pytest.approx(
        run.capture_s)                    # a replay captures nothing
    assert torch.equal(first[0], again[0])
    events = prof.profiler.kineto_results.events()
    host = [e.name() for e in events if e.device_type() == DeviceType.CPU]
    assert host.count("ps.scan.chunk") == 2
    assert host.count("ps.scan.tail") == 1
    assert all(e.is_user_annotation() for e in events
               if e.device_type() == DeviceType.CUDA
               and e.name().startswith("ps."))
