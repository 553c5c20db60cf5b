"""5-state models through the port's fused n-gram search, against the JAX
package's: a seeded synthetic model with 5 emitting states per phone
(left to right, self-loops, skips from every state), its host tables
(the finals' transitions as the fan kernel's 30 rows `tp_fin_rows` in
place of the JAX `tp_fin` [W, 5, 6]) equal, the 10 full-record arrays
and the hypothesis bit-equal through a frame of forced ties, and the 7
minimal-record arrays at B=4 with unequal lengths.  The finals block is
the fan step (`fan_step_ref` on the CPU, the kernel on the card) on a
padded fan carry, where the JAX scan runs its XLA block.

A 4-state model, a topology the fan kernel is not built for, goes the
same way on the CPU (the fan step's plain version takes any number of
states): its minimal and full records at B=3 equal the JAX scan's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pocketsphinx_tpu_torch.search.ngram_fused as port_fused
from pocketsphinx_tpu_torch.ops.fan import padded_width
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
    assert "tp_fin" not in ht
    assert ht["tp_fin_rows"].shape == (30, pt.n_multi)
    for k, v in jt.items():
        if k == "tp_fin":
            v, k = v.transpose(1, 2, 0).reshape(30, -1), "tp_fin_rows"
        elif k.startswith("fd_oh"):
            v, k = np.argmax(v, axis=0), "fd_idx" + k[5:]
        elif k == "f0_onehot":
            v, k = np.argmax(v, axis=1), "f0p_E"
        elif k == "lp_oh":
            v, k = np.argmax(v, axis=0), "lp_idx"
        np.testing.assert_array_equal(ht[k], v, err_msg=k)


def test_decode_records_equal(decoders, monkeypatch):
    jx, pt = decoders

    fan, calls = port_fused.fan_step, []

    def spy_fan(*a, **k):
        calls.append(a[0].shape)
        return fan(*a, **k)

    monkeypatch.setattr(port_fused, "fan_step", spy_fan)
    costs = tie_costs(pt.am.n_sen, 48, seed=19)
    hj, sj = jx.decode(None, costs=costs)
    hp, sp = pt.decode(None, costs=costs)
    assert len(calls) == 48 and calls[0][1] == 5
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
    """The finals of a 5-state model are the fan step, as the chain
    block is the chain kernel's: the fan and chain carries the step
    returns are their steps' new scores as they made them, with the
    frame's renormalization pending for the next frame's steps
    (`m_prev`), which subtract it as they load the scores; only a carry
    leaving the scan is folded."""
    _, pt = decoders
    assert pt.NST == 5
    fans, chains, args = [], [], []
    for name, out in (("fan_step", fans), ("chain_group_step", chains)):
        fn = getattr(port_fused, name)

        def spy(*a, _f=fn, _out=out, **k):
            args.append(k["m_prev"].clone())
            res = _f(*a, **k)
            _out.append(res[0])
            return res
        monkeypatch.setattr(port_fused, name, spy)
    costs = torch.as_tensor(tie_costs(pt.am.n_sen, pt.CHUNK, seed=21))
    valid = torch.ones((1, pt.CHUNK), dtype=torch.bool)
    prev = torch.zeros(1)
    steps = list(pt._steps(pt.init_carry(1), costs[None], valid, 0, False,
                           False))
    assert len(fans) == len(chains) == pt.CHUNK
    for i, c, rec in steps:
        m = rec[8]
        assert torch.equal(c["fin"]["S"], fans[i])
        assert torch.equal(c["chain"]["S"], chains[i])
        assert torch.equal(args[2 * i], prev)            # the chain step's
        assert torch.equal(args[2 * i + 1], prev)        # the fan step's
        assert torch.equal(c["m_prev"], m)
        prev = m
    assert bool((c["fin"]["S"][..., pt.n_multi:] == port_fused.NEG_INF)
                .all())


def test_with_carry_resumed_equals_jax(decoders):
    """Two masked blocks, the second resumed at frame 37 with a padded
    tail: records equal the JAX `with_carry`'s, and the carry after the
    second block equals the JAX carry (the chain and fan carries'
    pending offset folded in as it leaves the scan; the fan carry's real
    columns)."""
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
    W = pt.n_multi              # the port pads its fan carry, JAX does not
    pairs += [(carry["fin"][k][0, ..., :W], jcarry["fin"][k])
              for k in ("S", "TF", "CTX")]
    pairs += [(carry["sp"][k][0], jcarry["sp"][k]) for k in ("S", "TF",
                                                             "CTX")]
    for i, (a, b) in enumerate(pairs):
        if isinstance(b, (tuple, list)):          # one array per state
            b = np.stack([np.asarray(x) for x in b])
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=str(i))


@pytest.fixture(scope="module")
def four_states(tmp_path_factory):
    d = tmp_path_factory.mktemp("nst4")
    dic = str(d / "small.dic")
    words = synth.small_dictionary(dic, n_words=30, n_single=3, seed=16)
    lmf = synth.write_arpa(words, str(d / "small.arpa"), seed=17)
    spec = synth.make_model([dic], seed=18, n_sen=168 + 400, n_density=8,
                            n_state=4)
    assert spec.tmat.shape == (42, 4, 5)
    return (jax_decoder(spec, str(d), dic, lmf, topk=TOPK),
            synth.build_decoder(spec, str(d), dic, lmf, topk=TOPK,
                                device="cpu"))


@pytest.mark.parametrize("minimal", [True, False], ids=["minimal", "full"])
def test_four_states_scan_equals_jax(four_states, minimal, monkeypatch):
    """A 4-state model's scan at B=3 with unequal lengths and a frame of
    forced ties: the fan step (its plain version) steps every frame's
    word-final block on the padded fan carry, and the records equal the
    JAX scan's (its XLA finals block)."""
    jx, pt = four_states
    assert jx.NST == pt.NST == 4 and pt.n_multi
    assert pt.init_carry(1)["fin"]["S"].shape[-1] == padded_width(pt.n_multi)
    fan, calls = port_fused.fan_step, []
    monkeypatch.setattr(port_fused, "fan_step",
                        lambda *a, **k: (calls.append(a[0].shape[1]),
                                         fan(*a, **k))[1])
    lens = np.array([40, 17, 33])
    T = int(lens.max())
    costs = np.stack([tie_costs(pt.am.n_sen, T, seed=30 + b)
                      for b in range(len(lens))])
    valid = np.arange(T)[None, :] < lens[:, None]
    rj = jax.vmap(jx._make_scan(minimal=minimal))(jnp.asarray(costs),
                                                  jnp.asarray(valid))
    rp = pt.scan(torch.as_tensor(costs), torch.as_tensor(valid),
                 minimal=minimal)
    assert calls == [4] * 48
    assert_records_equal(rp, rj, MINIMAL if minimal else FULL)
