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


def test_step_subtracts_the_fan_carry(decoders, monkeypatch):
    """The finals of a 5-state model are torch ops, not the fan kernel:
    the step subtracts the frame's renormalization from the fan carry
    itself, while the chain carry it returns is the chain kernel's new
    scores with the offset pending for the next launch (`m_prev`)."""
    _, pt = decoders
    assert not pt._fan_folds
    fins, chains, fold = [], [], port_fused.chain_group_step
    finals = pt._finals_step

    def spy_finals(*a, **k):
        out = finals(*a, **k)
        fins.append(out[0]["S"].clone())
        return out

    def spy_chain(*a, **k):
        chains.append(k["m_prev"].clone())
        out = fold(*a, **k)
        chains.append(out[0])
        return out

    monkeypatch.setattr(pt, "_finals_step", spy_finals)
    monkeypatch.setattr(port_fused, "chain_group_step", spy_chain)
    costs = torch.as_tensor(tie_costs(pt.am.n_sen, pt.CHUNK, seed=21))
    valid = torch.ones((1, pt.CHUNK), dtype=torch.bool)
    prev = torch.zeros(1)
    for i, c, rec in pt._steps(pt.init_carry(1), costs[None], valid, 0,
                               False, False):
        m = rec[8]
        assert torch.equal(c["fin"]["S"], fins[i] - m[:, None, None, None])
        assert torch.equal(chains[2 * i], prev)
        assert torch.equal(c["chain"]["S"], chains[2 * i + 1])
        assert torch.equal(c["m_prev"], m)
        prev = m


def test_with_carry_resumed_equals_jax(decoders):
    """Two masked blocks, the second resumed at frame 37 with a padded
    tail: records equal the JAX `with_carry`'s, and the carry after the
    second block equals the JAX carry (the chain carry's pending offset
    folded in as it leaves the scan, the fan carry renormalized in
    the step)."""
    jx, pt = decoders
    costs = tie_costs(pt.am.n_sen, 80, seed=22)
    jscan = jx._make_scan(mask_carry=True)
    carry = jcarry = None
    for t0, n in ((0, 37), (37, 43)):
        valid = np.arange(n) < (n if t0 == 0 else n - 6)
        c = costs[t0:t0 + n]
        recs, carry = pt.with_carry(torch.as_tensor(c)[None],
                                    torch.as_tensor(valid)[None], carry, t0)
        jrecs, jcarry = jscan.with_carry(jnp.asarray(c), jnp.asarray(valid),
                                         jcarry, t0)
        assert_records_equal([r[0, :n] for r in recs],
                             [np.asarray(r)[:n] for r in jrecs], FULL)
    ch, ci = pt._chain_views(carry["chain"], 1)
    pairs = [(e[k][0], je[k]) for e, je in zip(
        ch + ci, jcarry["ch"] + jcarry["ci"], strict=True) for k in e]
    pairs += [(carry[n][k][0], jcarry[n][k]) for n in ("fin", "sp")
              for k in ("S", "TF", "CTX")]
    for i, (a, b) in enumerate(pairs):
        if isinstance(b, (tuple, list)):          # one array per state
            b = np.stack([np.asarray(x) for x in b])
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=str(i))
