"""The port's flat n-gram search (`search.ngram_flat`) is bit-equal to the
JAX package's given the same cost matrix: the mpx chain rows of
`append_word_chain_mpx`, the host network and LM tables, all 7 record
arrays, hypotheses and segments, through `decode` and through
`decode_batch` at B=3 with unequal lengths (each row also equal to its own
B=1 decode), with the trigram-context LM rows and with the bigram-only
rows (a small `LM_TABLE_BUDGET` on the instance).  The scan through its
chunked runner (the counterpart of the JAX `_make_scan`'s `jax.jit`: T
padded to whole 16-frame chunks with invalid frames) equals the JAX
records and the eager loop (`graph=False`), carry included, at B=8 with
unequal lengths.  The JAX side
backtraces in its C extension, the port in Python: the segments must
agree.  A small dictionary (bench-1.7k picks plus fillers) with a seeded
ARPA trigram LM, one frame of tied costs so that every max ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pocketsphinx_tpu.models.acoustic as jax_acoustic
from pocketsphinx_tpu.lm.ngram import read_lm as jax_read_lm
from pocketsphinx_tpu.models import chains as jax_chains
from pocketsphinx_tpu.search.ngram_flat import NgramFlatDecoder as JaxFlat
from pocketsphinx_tpu_torch.lm.ngram import read_lm
from pocketsphinx_tpu_torch.models import chains
from pocketsphinx_tpu_torch.search.ngram_flat import NgramFlatDecoder
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import model_pair, tie_costs, torch_one_thread  # noqa: F401,E501

RECORDS = "escore estf eprw eascr eh1 eh2 ectx".split()


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("flat")
    dic = str(d / "small.dic")
    words = synth.small_dictionary(dic, n_words=30, n_single=3, seed=4)
    lmf = synth.write_arpa(words, str(d / "small.arpa"), seed=5)
    spec = synth.make_model([dic], seed=6, n_sen=126 + 300, n_density=8)
    (jam, jd2p), (pam, pd2p) = model_pair(spec, str(d), dic)
    return jam, jd2p, pam, pd2p, lmf


@pytest.fixture(scope="module", params=["trigram", "bigram"])
def decoders(request, task):
    jam, jd2p, pam, pd2p, lmf = task
    jx = JaxFlat(jam, jd2p, jax_read_lm(lmf, lw=6.5, wip=0.65))
    pt = NgramFlatDecoder(pam, pd2p, read_lm(lmf, lw=6.5, wip=0.65),
                          device="cpu")
    if request.param == "bigram":
        jx.LM_TABLE_BUDGET = pt.LM_TABLE_BUDGET = 1000
    jx._lm_tables()
    pt._lm_tables()
    assert jx.lm_order_used == pt.lm_order_used == (
        3 if request.param == "trigram" else 2)
    return jx, pt


def test_chain_rows_equal_jax(task):
    jam, jd2p, pam, pd2p, _ = task
    rows = {}
    for pkg, mod, am, d2p in (("jax", jax_chains, jam, jd2p),
                              ("port", chains, pam, pd2p)):
        r = mod.ChainRows()
        out = [mod.append_word_chain_mpx(r, d2p.dict, am.mdef, d2p, wid, i,
                                         am.mdef.n_ciphone)
               for i, wid in enumerate(range(len(d2p.dict)))]
        rows[pkg] = (r, out)
    (jr, jo), (pr, po) = rows["jax"], rows["port"]
    for k in ("senid", "tmat", "chain_pred", "owner"):
        np.testing.assert_array_equal(np.asarray(getattr(pr, k)),
                                      np.asarray(getattr(jr, k)), err_msg=k)
    assert any(c.single for c in po) and any(c.filler for c in po)
    for a, b in zip(jo, po):
        for k in ("first_lo", "first_hi", "n_slot", "final_nodes",
                  "final_base_ci", "single", "filler"):
            assert getattr(a, k) == getattr(b, k), k
        np.testing.assert_array_equal(a.lc_cls, b.lc_cls)
        np.testing.assert_array_equal(a.rc_cls, b.rc_cls)


def test_host_tables_equal_jax(decoders):
    jx, pt = decoders
    for k in ("senid", "tp", "chain_pred", "node_word", "entry_mask",
              "exit_slot", "exit_slot_sil", "slot_members", "word_slots",
              "fg_members", "fb_perm", "fb_bounds", "col_lm"):
        a, b = getattr(jx, k), getattr(pt, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    for a, b in zip(jx._lm_tables(), pt._lm_tables()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    assert (jx.words, jx.start_idx, jx.finish_idx) == \
        (pt.words, pt.start_idx, pt.finish_idx)


def _segs(segs):
    return [(s.word, s.start, s.end) for s in segs]


def _assert_records(port, jax_recs):
    assert len(port) == len(jax_recs) == len(RECORDS)
    for n, a, b in zip(RECORDS, jax_recs, port):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, n
        np.testing.assert_array_equal(b, a, err_msg=n)


def test_decode_equal_jax(decoders):
    jx, pt = decoders
    costs = tie_costs(pt.am.n_sen, 60, seed=8)
    hj, sj = jx.decode(None, costs=costs)
    hp, sp = pt.decode(None, costs=costs)
    _assert_records(pt.records, jx.records)
    assert (hp, _segs(sp)) == (hj, _segs(sj))
    assert hp


def test_decode_batch_equal_jax(decoders, monkeypatch):
    jx, pt = decoders
    T, lens = 48, [48, 31, 17]
    costs = np.stack([tie_costs(pt.am.n_sen, T, seed=20 + b, tie_frame=9)
                      for b in range(3)])
    # the JAX flat decoder's batch scores features: give it these costs
    monkeypatch.setattr(jax_acoustic, "senone_scores_jax",
                        lambda *a, **k: jnp.asarray(costs))
    out_j = jx.decode_batch(np.zeros((3, T, 3, 13), np.float32), lens)
    out_p = pt.decode_batch(None, lens, costs=costs)
    for b, n in enumerate(lens):
        rec_j = tuple(np.asarray(r)[:n] for r in jx.batch_records[b])
        rec_p = tuple(np.asarray(r)[:n] for r in pt.batch_records[b])
        _assert_records(rec_p, rec_j)
        assert (out_p[b][0], _segs(out_p[b][1])) == \
            (out_j[b][0], _segs(out_j[b][1]))
        h1, s1 = pt.decode(None, costs=costs[b, :n])
        _assert_records(pt.records, rec_p)
        assert (h1, _segs(s1)) == (out_p[b][0], _segs(out_p[b][1]))


def test_with_carry_blocks_equal_whole(decoders):
    """The streaming scan in blocks of 16 frames, the last one padded and
    masked, equals one scan of the whole utterance."""
    _, pt = decoders
    costs = torch.as_tensor(tie_costs(pt.am.n_sen, 40, seed=31))[None]
    whole = pt.scan(costs, torch.ones((1, 40), dtype=torch.bool))
    carry, got = None, []
    for t0 in range(0, 48, 16):
        blk = costs[:, t0:t0 + 16]
        n = blk.shape[1]
        blk = torch.nn.functional.pad(blk, (0, 0, 0, 16 - n))
        valid = (torch.arange(16) < n)[None]
        recs, carry = pt.with_carry(blk, valid, carry, t0)
        got.append([r[:, :n] for r in recs])
    for k in range(len(RECORDS)):
        assert torch.equal(torch.cat([g[k] for g in got], 1), whole[k])


def test_scan_graph_equal_jax_and_eager(decoders, monkeypatch):
    jx, pt = decoders
    lens = [37, 20, 5, 37, 1, 33, 16, 29]
    B, T = len(lens), max(lens)
    costs = np.stack([tie_costs(pt.am.n_sen, T, seed=40 + b, tie_frame=11)
                      for b in range(B)])
    monkeypatch.setattr(jax_acoustic, "senone_scores_jax",
                        lambda *a, **k: jnp.asarray(costs))
    jx.decode_batch(np.zeros((B, T, 3, 13), np.float32), lens)
    c = torch.as_tensor(costs)
    valid = torch.arange(T)[None, :] < torch.as_tensor(lens)[:, None]
    assert pt.graph
    rg, cg = pt.with_carry(c, valid)
    runner = pt.chunk_graph
    assert runner is not None and runner.shape == (B, pt.am.n_sen)
    re_, ce = pt.with_carry(c, valid, graph=False)
    for a, b in zip(rg, re_):
        assert a.shape == (B, T, pt.W) and torch.equal(a, b)
    for a, b in zip(cg, ce):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    for b, n in enumerate(lens):
        _assert_records(tuple(r[b, :n].numpy() for r in rg),
                        tuple(np.asarray(r)[:n] for r in jx.batch_records[b]))
    # resumed from the carry at frame T, the runner of this B is kept
    rg2, _ = pt.with_carry(c[:, :9], valid[:, :9], cg, T)
    re2, _ = pt.with_carry(c[:, :9], valid[:, :9], ce, T, graph=False)
    assert pt.chunk_graph is runner
    for a, b in zip(rg2, re2):
        assert torch.equal(a, b)
