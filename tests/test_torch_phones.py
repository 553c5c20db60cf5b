"""A model with more than 64 CI phones (`synth.make_model(...,
n_extra_phones=28)`: 70 phones, some of them ending words, so that the
word-transition block's accept table needs two 64-bit words per column)
decoded by the JAX package and by the port from the same seeded costs:
full records, hypothesis and score of `decode`, the minimal records of a
B=8 scan with unequal lengths, and `decode_batch`, bit-equal, in LM
modes rows, B and C.  Also: the packed accept table of that decoder, and
the fan's diphone cap."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pocketsphinx_tpu.models.acoustic as jax_acoustic
from pocketsphinx_tpu_torch.ops import fan
from pocketsphinx_tpu_torch.search import ngram_fused
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import (assert_records_equal, jax_decoder, tie_costs,
                                torch_one_thread)  # noqa: F401

N_EXTRA = 28                                       # 42 + 28 = 70 phones
FULL = "escore etf etgt ecx entry eprw erw1 erw2 m nviol".split()
MINIMAL = "kv ki etf etgt rank m nviol".split()
LENS = [40, 23, 31, 9, 40, 17, 35, 28]             # B=8, unequal
MODES = {"rows": 8, "sparse": 8, "csr": 10 ** 6}   # mode: topk (C: K = W)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("phones")
    dic = str(d / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=6,
                                   n_extra_phones=N_EXTRA)
    lmf = synth.write_arpa(words, str(d / "small.arpa"), seed=8)
    spec = synth.make_model([dic], seed=9, n_sen=3 * (42 + N_EXTRA) + 300,
                            n_density=8, n_extra_phones=N_EXTRA)
    return d, dic, lmf, spec


@pytest.fixture(scope="module", params=list(MODES))
def decoders(request, task):
    d, dic, lmf, spec = task
    mode = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("PS_LM_MODE", mode)
    if mode == "csr":
        mp.setenv("PS_LM_TABLE_BYTES", "1000")
    try:
        jx = jax_decoder(spec, str(d), dic, lmf, topk=MODES[mode])
        jx._make_scan()                      # builds the LM tables
        pt = synth.build_decoder(spec, str(d), dic, lmf, topk=MODES[mode],
                                 device="cpu")
    finally:
        mp.undo()
    assert jx.lm_mode == pt.lm_mode == mode
    return jx, pt


def test_phone_set_needs_two_words(decoders):
    """70 CI phones, words that end in phones 64 and up, and the accept
    table packed into two words per column, bit for bit."""
    _, pt = decoders
    n_ci = pt.am.mdef.n_ciphone
    assert n_ci == 42 + N_EXTRA
    assert int(pt.fb_ci.max()) >= 64
    acc = pt.tables["accept_E"].numpy()
    bits = pt.tables["accept_bits"].numpy().view(np.uint64)
    assert bits.shape == (2, pt.nE) and acc.shape == (pt.nE, n_ci)
    for c in range(n_ci):
        got = (bits[c // 64] >> np.uint64(c % 64)) & np.uint64(1)
        np.testing.assert_array_equal(got, acc[:, c], err_msg=str(c))
    # the fan's diphone costs stay under its shared-memory cap
    LP = pt.senid_fin_d.shape[-1]
    assert 0 < LP and fan._groups(8, 4, LP, 132) in fan.GROUPS


def test_decode_full_records_equal_jax(decoders, monkeypatch):
    jx, pt = decoders
    seen, inner = [], ngram_fused.transitions

    def spy(*a, **k):
        seen.append(a[5])                    # fb_k
        return inner(*a, **k)
    monkeypatch.setattr(ngram_fused, "transitions", spy)
    costs = tie_costs(pt.am.n_sen, 45, seed=3)
    hj, sj = jx.decode(None, costs=costs)
    hp, sp = pt.decode(None, costs=costs)
    assert_records_equal(pt.raw_records, jx.raw_records, FULL)
    key = lambda s: [(x.word, x.start, x.end) for x in s]  # noqa: E731
    assert (hp, key(sp)) == (hj, key(sj)) and hp
    assert pt.hyp_score == jx.hyp_score
    assert pt.guard_violations == jx.guard_violations
    # exits whose final phone is in the second accept word took part
    assert any(bool((fb >= 64).any()) for fb in seen)


def _batch(n_sen, seed):
    T = max(LENS)
    costs = np.stack([tie_costs(n_sen, T, seed + b) for b in range(8)])
    return costs, np.asarray(LENS, np.int32)


def test_minimal_records_equal_jax(decoders):
    jx, pt = decoders
    costs, nf = _batch(pt.am.n_sen, seed=20)
    valid = np.arange(costs.shape[1])[None, :] < nf[:, None]
    rj = jax.vmap(jx._make_scan(minimal=True))(jnp.asarray(costs),
                                               jnp.asarray(valid))
    rp = pt.scan(torch.as_tensor(costs), torch.as_tensor(valid),
                 minimal=True)
    assert_records_equal(rp, rj, MINIMAL)


def test_decode_batch_equal_jax(decoders, monkeypatch):
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
