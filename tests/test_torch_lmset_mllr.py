"""The port's `-lmctl` LM sets and `update_mllr` against the JAX
package's, through both `Decoder`s on one synthetic model directory:

  * an lmctl file of two seeded ARPA LMs: the set's weights, and
    `decode_senscr` results under `-lmname` and after
    `activate_search`, exactly equal;
  * a seeded MLLR transform: the transformed Gaussians bit-equal, the
    port's senone costs move with it (its cached device tensors are
    dropped) and agree with the JAX costs within 2e-2 units, hyps equal;
    `update_mllr(None)` restores the original costs exactly."""

from dataclasses import astuple

import numpy as np
import pytest

from pocketsphinx_tpu.decoder import Decoder as JaxDecoder
from pocketsphinx_tpu.lm.lmset import NgramModelSet as JaxSet
from pocketsphinx_tpu.models.acoustic import senone_scores_jax
from pocketsphinx_tpu_torch import Decoder
from pocketsphinx_tpu_torch.lm.lmset import NgramModelSet
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import torch_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("lmset")
    hmm, dic, lmf = synth.small_task(str(d), seed=9)
    words = [ln.split()[0] for ln in open(dic)]
    synth.write_arpa(words, str(d / "b.arpa"), seed=21, p_bigram=0.5)
    (d / "set.lmctl").write_text(f"{lmf} first\nb.arpa second\n")
    return hmm, dic, str(d / "set.lmctl"), lmf


def _result(d):
    return astuple(d.hyp()), [(s.word, s.start_frame, s.end_frame, s.prob)
                              for s in d.seg_iter()]


def test_lmctl_set_equal(task):
    hmm, dic, lmctl, _ = task
    p, j = NgramModelSet.read_lmctl(lmctl, 6.5, 0.65), \
        JaxSet.read_lmctl(lmctl, 6.5, 0.65)
    assert list(p) == list(j) == ["first", "second"]
    assert p.lweights == j.lweights and p.active == j.active
    p.interp(weights=[0.3, 0.7])
    j.interp(weights=[0.3, 0.7])
    assert p.lweights == j.lweights


def test_lmctl_decode_equal(task):
    hmm, dic, lmctl, _ = task
    pd = Decoder(hmm=hmm, dict=dic, lmctl=lmctl, lmname="second",
                 device="cpu")
    jd = JaxDecoder(hmm=hmm, dict=dic, lmctl=lmctl, lmname="second")
    assert pd.current_search_name() == jd.current_search_name() == "second"
    costs = np.random.default_rng(3).uniform(
        0, 400, (80, pd.am.n_sen)).astype(np.float32)
    got = []
    for name in ("second", "first"):
        for d in (pd, jd):
            d.activate_search(name)
            d.decode_senscr(costs)
        assert _result(pd) == _result(jd)
        got.append(pd.hyp().hypstr)
    assert all(got)


def _mllr_file(path, seed):
    rng = np.random.default_rng(seed)
    lines = ["1", "3"]
    for _ in range(3):
        A = np.eye(13) + 0.03 * rng.standard_normal((13, 13))
        lines += ["13"] + [" ".join(f"{x:.6f}" for x in row) for row in A]
        lines.append(" ".join(f"{x:.6f}" for x in 0.2 * rng.standard_normal(13)))
        lines.append(" ".join(f"{x:.6f}" for x in rng.uniform(0.9, 1.2, 13)))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_update_mllr_equal(task, tmp_path):
    hmm, dic, _, lmf = task
    pd = Decoder(hmm=hmm, dict=dic, lm=lmf, device="cpu")
    jd = JaxDecoder(hmm=hmm, dict=dic, lm=lmf)
    pcm = synth.make_pcm(51, 2.0)
    pd.decode_raw(pcm)
    before = pd._scores(pd._feats).numpy()
    mllr = _mllr_file(tmp_path / "mllr", seed=4)
    for d in (pd, jd):
        d.update_mllr(mllr)
        d.set_cmn("40,3,-1")
        d.decode_raw(pcm)
    np.testing.assert_array_equal(pd.am.gauden.means, jd.am.gauden.means)
    np.testing.assert_array_equal(pd.am.gauden.prec, jd.am.gauden.prec)
    np.testing.assert_array_equal(pd._feats, jd._feats)
    after = pd._scores(pd._feats).numpy()
    cj = np.asarray(senone_scores_jax(jd.am.scoring_arrays, jd.am.cb_groups,
                                      jd._feats[None]))[0]
    np.testing.assert_allclose(after, cj, atol=2e-2, rtol=0)
    assert np.abs(after - before).max() > 1.0       # the model moved
    assert pd.hyp().hypstr == jd.hyp().hypstr
    pd.update_mllr(None)
    np.testing.assert_array_equal(pd._scores(pd._feats).numpy(), before)
