"""LM mode C ("csr", the fully sparse LM tables of the reference-scale
vocabulary) in the port's fused n-gram search, against the JAX package's
mode C on the same synthetic model, dictionary, LM and cost matrices.
Mode C is forced (PS_LM_MODE=csr, PS_LM_TABLE_BYTES=1000), with the
JAX default FAT_CAP and with FAT_CAP=2, so that nearly every history
takes the dense "fat" row path:

  * the host tables equal the JAX `_lm_sparse` and `_dev_tables`;
  * the 10 full records of `decode`, the 7 minimal records of the B=8
    scan with unequal lengths, and `decode_batch`'s hypotheses, scores
    and guard counts are bit-equal to JAX;
  * the port's mode C against its mode B meets the contract of
    tests/test_lm_mode_csr.py: the same hypothesis and integer records,
    scores within one float32 rounding of the base row (2e-3 units);
  * a `with_carry` stream of 32-frame blocks equals the whole scan."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pocketsphinx_tpu.models.acoustic as jax_acoustic
from pocketsphinx_tpu.search.ngram_fused import NgramFusedDecoder as JaxNgram
from pocketsphinx_tpu_torch.search.ngram_fused import NgramFusedDecoder
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import (assert_records_equal, jax_decoder, tie_costs,
                                torch_one_thread)  # noqa: F401

TOPK = 8
FULL = "escore etf etgt ecx entry eprw erw1 erw2 m nviol".split()
MINIMAL = "kv ki etf etgt rank m nviol".split()
INT_RECS = [1, 2, 3, 5, 6, 7]
LENS = [50, 33, 17, 50, 41, 9, 26, 48]          # B=8, unequal


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("csr")
    dic = str(d / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=2)
    lmf = synth.write_arpa(words, str(d / "small.arpa"), seed=4)
    spec = synth.make_model([dic], seed=5, n_sen=126 + 300, n_density=8)
    return d, dic, lmf, spec


def _build(task, mode, fat_cap=None, jax_too=True):
    """(JAX decoder or None, port decoder) built in LM `mode`."""
    d, dic, lmf, spec = task
    mp = pytest.MonkeyPatch()
    mp.setenv("PS_LM_MODE", mode)
    mp.setenv("PS_LM_TABLE_BYTES", "1000")
    if fat_cap is not None:
        mp.setattr(JaxNgram, "FAT_CAP", fat_cap)
        mp.setattr(NgramFusedDecoder, "FAT_CAP", fat_cap)
    try:
        jx = None
        if jax_too:
            jx = jax_decoder(spec, str(d), dic, lmf, topk=TOPK)
            jx._make_scan()                      # builds the LM tables
        pt = synth.build_decoder(spec, str(d), dic, lmf, topk=TOPK,
                                 device="cpu")
    finally:
        mp.undo()
    assert pt.lm_mode == mode and (jx is None or jx.lm_mode == mode)
    return jx, pt


@pytest.fixture(scope="module", params=[None, 2], ids=["csr", "fat"])
def decoders(request, task):
    jx, pt = _build(task, "csr", request.param)
    assert (pt.N_FAT > 0) == (request.param == 2)
    return jx, pt


def test_host_tables_equal_jax(decoders):
    jx, pt = decoders
    for k, v in jx._lm_sparse.items():
        np.testing.assert_array_equal(pt._lm_sparse[k], v, err_msg=k)
        assert np.asarray(pt._lm_sparse[k]).dtype == np.asarray(v).dtype, k
    jt = {k: np.asarray(v) for k, v in jx._dev_tables.items()}
    ht = pt.host_tables
    assert "ctx_next" not in ht and "bg" not in ht
    for k in ("uni_row", "umeta", "fat_rows", "fat_ctx", "ctx_base",
              "bg_cols", "bg_vals", "bg_ctx", "bgmeta", "maxb_E"):
        assert ht[k].dtype == jt[k].dtype, k
        np.testing.assert_array_equal(ht[k], jt[k], err_msg=k)
    assert "guard_w" not in ht and "guard_w" not in jt   # global bound
    assert set(jt) - set(ht) <= {"f0_onehot", "lp_oh", "tp_fin"} | {
        k for k in jt if k.startswith("fd_oh")}


def test_decode_full_records_equal(decoders):
    jx, pt = decoders
    costs = tie_costs(pt.am.n_sen, 50, seed=5)
    hj, sj = jx.decode(None, costs=costs)
    hp, sp = pt.decode(None, costs=costs)
    assert_records_equal(pt.raw_records, jx.raw_records, FULL)
    key = lambda s: [(x.word, x.start, x.end) for x in s]  # noqa: E731
    assert (hp, key(sp)) == (hj, key(sj)) and hp
    assert pt.hyp_score == jx.hyp_score
    assert pt.guard_violations == jx.guard_violations


def test_port_scan_on_jax_tables(decoders):
    """`convert.scan_tables` carries the JAX decoder's mode-C tables over:
    the port's scan on them gives the port's own records."""
    jx, pt = decoders
    other = pt.to("cpu")
    other.tables = pt.device_tables({k: np.asarray(v)
                                     for k, v in jx._dev_tables.items()},
                                    "cpu")
    assert other.tables["bg_cols"].dtype == torch.int64
    assert other.tables["umeta"].dtype == torch.int32
    costs = torch.as_tensor(tie_costs(pt.am.n_sen, 30, seed=8))[None]
    valid = torch.ones((1, 30), dtype=torch.bool)
    assert_records_equal(other.scan(costs, valid), pt.scan(costs, valid),
                         FULL)


def _batch(n_sen, seed):
    T = max(LENS)
    costs = np.stack([tie_costs(n_sen, T, seed + b) for b in range(8)])
    return costs, np.asarray(LENS, np.int32)


def test_minimal_records_equal(decoders):
    jx, pt = decoders
    costs, nf = _batch(pt.am.n_sen, seed=20)
    valid = np.arange(costs.shape[1])[None, :] < nf[:, None]
    rj = jax.vmap(jx._make_scan(minimal=True))(jnp.asarray(costs),
                                               jnp.asarray(valid))
    rp = pt.scan(torch.as_tensor(costs), torch.as_tensor(valid),
                 minimal=True)
    assert_records_equal(rp, rj, MINIMAL)


def test_decode_batch_equal(decoders, monkeypatch):
    jx, pt = decoders
    costs, nf = _batch(pt.am.n_sen, seed=40)
    monkeypatch.setattr(jax_acoustic, "senone_scores_jax",
                        lambda *a, **k: jnp.asarray(costs))
    feats = np.zeros(costs.shape[:2] + (3, 13), np.float32)
    oj = jx.decode_batch(feats, nf, keep_records=False)
    op = pt.decode_batch(None, nf, keep_records=False,
                         costs=torch.as_tensor(costs))
    key = lambda o: [(h, [(x.word, x.start, x.end) for x in s])  # noqa: E731
                     for h, s in o]
    assert key(op) == key(oj)
    assert sum(bool(h) for h, _ in op) >= 4
    assert pt.hyp_scores == jx.hyp_scores
    assert pt.guard_violations_batch == jx.guard_violations_batch


def test_with_carry_stream_equals_whole(decoders):
    _, pt = decoders
    T, BL = 75, 32
    costs = torch.as_tensor(tie_costs(pt.am.n_sen, T, seed=9))
    whole = pt.scan(costs[None], torch.ones((1, T), dtype=torch.bool))
    carry, got = None, []
    for b0 in range(0, T, BL):
        blk = costs[b0:b0 + BL]
        n = len(blk)
        blk = torch.nn.functional.pad(blk, (0, 0, 0, BL - n))
        recs, carry = pt.with_carry(blk[None], (torch.arange(BL) < n)[None],
                                    carry, b0)
        got.append([r[0, :n] for r in recs])
    for k, n in enumerate(FULL):
        assert torch.equal(torch.cat([g[k] for g in got]), whole[k][0, :T]), n


def test_csr_against_sparse(task, decoders):
    """Port mode C against port mode B on one cost matrix: the JAX
    package's mode contract.  The guard count (nviol) may differ: mode C
    uses the global bound."""
    _, pc = decoders
    _, pb = _build(task, "sparse", jax_too=False)
    costs = tie_costs(pc.am.n_sen, 60, seed=13)
    hb, _ = pb.decode(None, costs=costs)
    hc, _ = pc.decode(None, costs=costs)
    assert hb == hc and hc
    rb, rc = pb.raw_records, pc.raw_records
    for i in INT_RECS:
        np.testing.assert_array_equal(rc[i], rb[i], err_msg=FULL[i])
    for i in (0, 4, 8):
        np.testing.assert_allclose(rc[i], rb[i], atol=2e-3, rtol=0,
                                   err_msg=FULL[i])
