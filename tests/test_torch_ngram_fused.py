"""The port's fused n-gram search is bit-equal to the JAX package's given
the same cost matrix: host tables, the 10 full-record and 7 minimal-record
arrays, hypotheses, segments, hyp scores and guard counts, through
`decode` and through `decode_batch` at B=8 with unequal lengths, in LM
modes rows and sparse (B).  A small dictionary (bench-1.7k picks plus
fillers) with a seeded ARPA trigram LM; topk below the vocabulary so the
shortlist, its tie order and the guard all matter."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pocketsphinx_tpu.models.acoustic as jax_acoustic
from _torch_jax_helpers import jax_decoder, torch_one_thread  # noqa: F401
from pocketsphinx_tpu_torch.testing import synth

TOPK = 8
FULL = "escore etf etgt ecx entry eprw erw1 erw2 m nviol".split()
MINIMAL = "kv ki etf etgt rank m nviol".split()


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("ngram")
    dic = str(d / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=0)
    lmf = synth.write_arpa(words, str(d / "small.arpa"), seed=3)
    spec = synth.make_model([dic], seed=1, n_sen=126 + 300, n_density=8)
    return d, dic, lmf, spec


@pytest.fixture(scope="module", params=["rows", "sparse"])
def decoders(request, task):
    d, dic, lmf, spec = task
    mp = pytest.MonkeyPatch()
    mp.setenv("PS_LM_MODE", request.param)
    try:
        jx = jax_decoder(spec, str(d), dic, lmf, topk=TOPK)
        jx._make_scan()                          # reads PS_LM_MODE
        pt = synth.build_decoder(spec, str(d), dic, lmf, topk=TOPK,
                                 device="cpu")
    finally:
        mp.undo()
    assert jx.lm_mode == pt.lm_mode == request.param
    return jx, pt


def _costs(n_sen, T, seed):
    # wide enough a spread that real words beat the fillers
    c = np.random.default_rng(seed).uniform(0, 400, (T, n_sen)).astype(
        np.float32)
    c[T // 3] = 1e29          # every score collapses onto one value: ties
    return c


def _segs(segs):
    return [(s.word, s.start, s.end) for s in segs]


def test_host_tables_equal_jax(decoders):
    jx, pt = decoders
    jt = {k: np.asarray(v) for k, v in jx._dev_tables.items()}
    ht = pt.host_tables
    for k, v in jt.items():
        if k in ht:
            assert ht[k].dtype == v.dtype, k
            np.testing.assert_array_equal(ht[k], v, err_msg=k)
        elif k.startswith("fd_oh"):
            idx = ht["fd_idx" + k[5:]]
            np.testing.assert_array_equal(
                (idx[None, :] == np.arange(v.shape[0])[:, None]), v == 1, k)
        elif k == "f0_onehot":
            np.testing.assert_array_equal(
                ht["f0p_E"][:, None] == np.arange(v.shape[1])[None, :],
                v == 1)
        elif k == "lp_oh":
            np.testing.assert_array_equal(
                ht["lp_idx"][None, :] == np.arange(v.shape[0])[:, None],
                v == 1)
        elif k == "tp_fin":
            np.testing.assert_array_equal(
                ht["tp_fin12"], v.transpose(1, 2, 0).reshape(12, -1))
        else:
            pytest.fail(f"JAX table {k} has no port counterpart")
    port_only = set(ht) - set(jt)
    assert all(k.startswith(("fd_idx", "tp_fin12", "lp_idx", "f0p_E"))
               for k in port_only), port_only


def test_decode_full_records_equal(decoders):
    jx, pt = decoders
    costs = _costs(pt.am.n_sen, 50, seed=5)
    hj, sj = jx.decode(None, costs=costs)
    hp, sp = pt.decode(None, costs=costs)
    for n, a, b in zip(FULL, jx.raw_records, pt.raw_records):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, n
        np.testing.assert_array_equal(b, a, err_msg=n)
    assert (hp, _segs(sp)) == (hj, _segs(sj))
    assert hp                                # words, not only fillers
    assert pt.hyp_score == jx.hyp_score
    assert pt.guard_violations == jx.guard_violations
    for n, a, b in zip(["escore", "estf", "eprw", "eascr", "eh1", "eh2",
                        "ectx"], jx.records, pt.records):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=n)


def test_port_scan_on_jax_tables(decoders):
    """The JAX decoder's own device tables, carried over by
    `convert.scan_tables` (through the decoder's `device_tables`), drive
    the port's scan to the same records."""
    jx, pt = decoders
    other = pt.to("cpu")
    other.tables = pt.device_tables({k: np.asarray(v)
                                     for k, v in jx._dev_tables.items()},
                                    "cpu")
    costs = torch.as_tensor(_costs(pt.am.n_sen, 20, seed=8))[None]
    valid = torch.ones((1, 20), dtype=torch.bool)
    for a, b in zip(other.scan(costs, valid), pt.scan(costs, valid)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _batch(n_sen, lens, seed):
    T = max(lens)
    costs = np.stack([_costs(n_sen, T, seed + b) for b in range(len(lens))])
    return costs, np.asarray(lens, np.int32)


LENS = [50, 33, 17, 50, 41, 9, 26, 48]          # B=8, unequal


def test_minimal_records_equal(decoders):
    jx, pt = decoders
    costs, nf = _batch(pt.am.n_sen, LENS, seed=20)
    valid = np.arange(costs.shape[1])[None, :] < nf[:, None]
    rj = jax.vmap(jx._make_scan(minimal=True))(jnp.asarray(costs),
                                               jnp.asarray(valid))
    rp = pt.scan(torch.as_tensor(costs), torch.as_tensor(valid),
                 minimal=True)
    assert len(rj) == len(rp) == len(MINIMAL)
    for n, a, b in zip(MINIMAL, rj, rp):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype, n
        np.testing.assert_array_equal(b.numpy(), a, err_msg=n)


@pytest.mark.parametrize("keep_records", [False, True])
def test_decode_batch_equal(decoders, keep_records, monkeypatch):
    jx, pt = decoders
    costs, nf = _batch(pt.am.n_sen, LENS, seed=40)
    # the JAX decode_batch scores its features itself: hand it the costs
    monkeypatch.setattr(jax_acoustic, "senone_scores_jax",
                        lambda *a, **k: jnp.asarray(costs))
    feats = np.zeros(costs.shape[:2] + (3, 13), np.float32)
    oj = jx.decode_batch(feats, nf, keep_records=keep_records)
    op = pt.decode_batch(None, nf, keep_records=keep_records,
                         costs=torch.as_tensor(costs))
    assert [(h, _segs(s)) for h, s in op] == [(h, _segs(s)) for h, s in oj]
    assert sum(bool(h) for h, _ in op) >= 4
    assert pt.hyp_scores == jx.hyp_scores
    assert pt.guard_violations_batch == jx.guard_violations_batch
    if keep_records:
        for b in (0, 5):
            for a, c in zip(jx.batch_records[b], pt.batch_records[b]):
                np.testing.assert_array_equal(c, np.asarray(a))
    else:
        assert pt.batch_records is None and jx.batch_records is None
