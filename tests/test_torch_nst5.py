"""5-state models through the port's fused n-gram search, against the JAX
package's: a seeded synthetic model with 5 emitting states per phone
(left to right, self-loops, skips from every state), its host tables
(the finals' `tp_fin` [W, 5, 6] in place of the fan kernel's 12 rows)
equal, the 10 full-record arrays and the hypothesis bit-equal through a
frame of forced ties, and the 7 minimal-record arrays at B=4 with
unequal lengths.  The fan kernel is never reached: the finals block is
the JAX scan's XLA block as torch ops."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pocketsphinx_tpu_torch.search.ngram_fused as port_fused
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import (  # noqa: F401
    assert_records_equal, jax_decoder, tie_costs, torch_one_thread)

TOPK = 8
FULL = "escore etf etgt ecx entry eprw erw1 erw2 m nviol".split()
MINIMAL = "kv ki etf etgt rank m nviol".split()


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    d = tmp_path_factory.mktemp("nst5")
    dic = str(d / "small.dic")
    words = synth.small_dictionary(dic, n_words=30, n_single=3, seed=16)
    lmf = synth.write_arpa(words, str(d / "small.arpa"), seed=17)
    spec = synth.make_model([dic], seed=18, n_sen=210 + 400, n_density=8,
                            n_state=5)
    assert spec.tmat.shape == (42, 5, 6)
    jx = jax_decoder(spec, str(d), dic, lmf, topk=TOPK)
    jx._make_scan()
    pt = synth.build_decoder(spec, str(d), dic, lmf, topk=TOPK,
                             device="cpu")
    assert jx.NST == pt.NST == 5
    return jx, pt


def test_host_tables_equal_jax(decoders):
    jx, pt = decoders
    jt = {k: np.asarray(v) for k, v in jx._dev_tables.items()}
    ht = pt.host_tables
    assert "tp_fin12" not in ht and ht["tp_fin"].shape[1:] == (5, 6)
    for k, v in jt.items():
        if k.startswith("fd_oh"):
            v, k = np.argmax(v, axis=0), "fd_idx" + k[5:]
        elif k == "f0_onehot":
            v, k = np.argmax(v, axis=1), "f0p_E"
        elif k == "lp_oh":
            v, k = np.argmax(v, axis=0), "lp_idx"
        np.testing.assert_array_equal(ht[k], v, err_msg=k)


def test_decode_records_equal(decoders, monkeypatch):
    jx, pt = decoders

    def no_fan(*a, **k):
        raise AssertionError("the fan step ran on a 5-state model")

    monkeypatch.setattr(port_fused, "fan_step", no_fan)
    costs = tie_costs(pt.am.n_sen, 48, seed=19)
    hj, sj = jx.decode(None, costs=costs)
    hp, sp = pt.decode(None, costs=costs)
    assert_records_equal(pt.raw_records, jx.raw_records, FULL)
    assert (hp, [(s.word, s.start, s.end) for s in sp]) == \
        (hj, [(s.word, s.start, s.end) for s in sj])
    assert hp and pt.hyp_score == jx.hyp_score


def test_minimal_batch_equal(decoders):
    jx, pt = decoders
    lens = np.array([40, 17, 33, 26])
    T = int(lens.max())
    costs = np.stack([tie_costs(pt.am.n_sen, T, seed=20 + b)
                      for b in range(len(lens))])
    valid = np.arange(T)[None, :] < lens[:, None]
    rj = jax.vmap(jx._make_scan(minimal=True))(jnp.asarray(costs),
                                               jnp.asarray(valid))
    rp = pt.scan(torch.as_tensor(costs), torch.as_tensor(valid),
                 minimal=True)
    assert_records_equal(rp, rj, MINIMAL)
