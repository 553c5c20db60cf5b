"""The port's allphone search against the JAX package's, CI and triphone
(PHMM) networks, each with a seeded phone-bigram ARPA LM and without an
LM: the bigram matrix and the network tables equal, then the per-frame
exit records (out, start frame, predecessor class) bit-equal on one
seeded cost matrix with a frame of forced ties, and the phone string and
segments equal."""

import numpy as np
import pytest

from pocketsphinx_tpu.lm.ngram import read_lm as j_read_lm
from pocketsphinx_tpu.search.allphone import AllphoneDecoder as JAllphone
from pocketsphinx_tpu_torch.lm.ngram import read_lm
from pocketsphinx_tpu_torch.search.allphone import AllphoneDecoder
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import (  # noqa: F401
    assert_records_equal, model_pair, scan_outputs, tie_costs,
    torch_one_thread)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("allphone")
    dic = str(d / "small.dic")
    synth.small_dictionary(dic, n_words=30, seed=9)
    spec = synth.make_model([dic], seed=10, n_sen=126 + 300, n_density=8)
    lmf = synth.write_phone_arpa(str(d / "phone.arpa"), seed=11)
    return model_pair(spec, str(d), dic), lmf


@pytest.mark.parametrize("ci_only", [True, False])
@pytest.mark.parametrize("with_lm", [True, False])
def test_allphone_equal(task, ci_only, with_lm, monkeypatch):
    ((jam, _), (pam, _)), lmf = task
    jlm = j_read_lm(lmf, lw=6.5, wip=0.65) if with_lm else None
    plm = read_lm(lmf, lw=6.5, wip=0.65) if with_lm else None
    jx = JAllphone(jam, jlm, ci_only=ci_only, pip=0.9)
    pt = AllphoneDecoder(pam, plm, ci_only=ci_only, pip=0.9, device="cpu")
    for k in ("M", "node_ci", "senid", "tp", "lcmask", "rcmask"):
        a, b = getattr(jx, k), getattr(pt, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert pt.n_node == jx.n_node
    assert (pt.n_node > pam.mdef.n_ciphone) == (not ci_only)
    assert (np.unique(pt.M).size > 1) == with_lm
    costs = tie_costs(pam.n_sen, 60, seed=12)
    seen = scan_outputs(monkeypatch)
    hj, sj = jx.decode(None, costs=costs)
    hp, sp = pt.decode(None, costs=costs)
    assert_records_equal(pt.records, seen[-1][1], ["out", "stf", "prc"])
    assert (hp, [(s.word, s.start, s.end) for s in sp]) == \
        (hj, [(s.word, s.start, s.end) for s in sj])
    assert len(sp) >= 3
