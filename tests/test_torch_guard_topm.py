"""The exactness guard's opt-in refinement PS_GUARD_TOPM in the port's
fused n-gram search, against the JAX package's: with PS_GUARD_TOPM=4 and
topk=8 (K + GM below the vocabulary), in LM modes rows and sparse (B),

  * all 10 full records of `decode` and the 7 minimal records of the B=8
    scan with unequal lengths, `nviol` included, are bit-equal to JAX;
  * every record but `nviol` equals the same port decoder's GM=0 run, and
    `nviol` never grows (the exits ranked K..K+GM are bounded exactly)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import (assert_records_equal, jax_decoder, tie_costs,
                                torch_one_thread)  # noqa: F401

TOPK, GM = 8, 4
FULL = "escore etf etgt ecx entry eprw erw1 erw2 m nviol".split()
MINIMAL = "kv ki etf etgt rank m nviol".split()
LENS = [40, 27, 13, 40, 35, 9, 22, 38]


@pytest.fixture(scope="module", params=["rows", "sparse"])
def decoders(request, tmp_path_factory):
    """(JAX decoder with GM, port decoder with GM, port decoder GM=0)."""
    d = tmp_path_factory.mktemp("topm")
    dic = str(d / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=6)
    lmf = synth.write_arpa(words, str(d / "small.arpa"), seed=7)
    spec = synth.make_model([dic], seed=8, n_sen=126 + 300, n_density=8)
    mp = pytest.MonkeyPatch()
    mp.setenv("PS_LM_MODE", request.param)
    try:
        plain = synth.build_decoder(spec, str(d), dic, lmf, topk=TOPK,
                                    device="cpu")
        mp.setenv("PS_GUARD_TOPM", str(GM))
        jx = jax_decoder(spec, str(d), dic, lmf, topk=TOPK)
        jx._make_scan()                     # both scans read PS_GUARD_TOPM
        jx._make_scan(minimal=True)
        pt = synth.build_decoder(spec, str(d), dic, lmf, topk=TOPK,
                                 device="cpu")
    finally:
        mp.undo()
    assert pt.GM == GM and plain.GM == 0 and TOPK + GM < pt.W
    assert {"guard_bmax", "col_lm_W", "isfill_W"} <= set(jx._dev_tables)
    for k in ("guard_bmax", "col_lm_W", "isfill_W"):
        np.testing.assert_array_equal(pt.host_tables[k],
                                      np.asarray(jx._dev_tables[k]))
        assert pt.host_tables[k].dtype == np.asarray(jx._dev_tables[k]).dtype
    return jx, pt, plain


def test_full_records_equal_jax(decoders):
    jx, pt, _ = decoders
    costs = tie_costs(pt.am.n_sen, 45, seed=3)
    jx.decode(None, costs=costs)
    pt.decode(None, costs=costs)
    assert_records_equal(pt.raw_records, jx.raw_records, FULL)
    assert pt.guard_violations == jx.guard_violations


def test_port_scan_on_jax_tables(decoders):
    """`convert.scan_tables` carries the JAX decoder's `guard_bmax`,
    `col_lm_W` and `isfill_W` over: the port's scan on them gives the
    port's own records, `nviol` included."""
    jx, pt, _ = decoders
    other = pt.to("cpu")
    other.tables = pt.device_tables({k: np.asarray(v)
                                     for k, v in jx._dev_tables.items()},
                                    "cpu")
    assert other.tables["col_lm_W"].dtype == torch.int64
    costs = torch.as_tensor(tie_costs(pt.am.n_sen, 30, seed=8))[None]
    valid = torch.ones((1, 30), dtype=torch.bool)
    assert_records_equal(other.scan(costs, valid), pt.scan(costs, valid),
                         FULL)


def _batch(n_sen):
    costs = np.stack([tie_costs(n_sen, max(LENS), 30 + b) for b in range(8)])
    valid = np.arange(max(LENS))[None, :] < np.array(LENS)[:, None]
    return costs, valid


def test_minimal_records_equal_jax(decoders):
    jx, pt, _ = decoders
    costs, valid = _batch(pt.am.n_sen)
    rj = jax.vmap(jx._make_scan(minimal=True))(jnp.asarray(costs),
                                               jnp.asarray(valid))
    rp = pt.scan(torch.as_tensor(costs), torch.as_tensor(valid),
                 minimal=True)
    assert_records_equal(rp, rj, MINIMAL)


def test_only_nviol_changes(decoders):
    _, pt, plain = decoders
    costs, valid = _batch(pt.am.n_sen)
    costs, valid = torch.as_tensor(costs), torch.as_tensor(valid)
    rg, r0 = pt.scan(costs, valid), plain.scan(costs, valid)
    for n, a, b in zip(FULL[:-1], rg, r0):
        assert torch.equal(a, b), n
    assert bool((rg[-1] <= r0[-1]).all())
    assert int(rg[-1].sum()) < int(r0[-1].sum())
