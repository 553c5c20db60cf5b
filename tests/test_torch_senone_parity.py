"""The port's int-parity PTM scorer (`ops.senone_parity.PTMParityScorer`)
against the JAX package's on a seeded PTM synthetic model (both packages
load the same files, `_torch_jax_helpers.model_pair`) and seeded feature
frames: the int16 senone scores of every frame equal, with the top-N
state carried across frames; and `fileio.acoustic.read_mixw_float` of the
model directory's mixture weights equal."""

import os

import numpy as np
import pytest

from pocketsphinx_tpu.fileio.acoustic import read_mixw_float as jax_read_mixw
from pocketsphinx_tpu.ops.senone_parity import PTMParityScorer as JaxScorer
from pocketsphinx_tpu_torch.fileio.acoustic import read_mixw_float
from pocketsphinx_tpu_torch.ops.senone_parity import PTMParityScorer
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import model_pair, torch_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity")
    dic = str(d / "small.dic")
    synth.small_dictionary(dic, n_words=20, seed=2)
    spec = synth.make_model([dic], seed=3, n_sen=126 + 200, n_density=16)
    return d, spec, model_pair(spec, str(d), dic)


@pytest.mark.parametrize("topn", [2, 4])
def test_int_scores_equal_jax(task, topn):
    _, spec, ((jam, _), (pam, _)) = task
    rng = np.random.default_rng(10 + topn)
    # feature frames around the model's means, so scores spread and
    # the top-N shortlist changes from frame to frame
    mu = spec.means.mean(axis=(0, 2))                    # [F, L]
    feats = (mu[None] + rng.normal(0, 1.5, (25,) + mu.shape)).astype(
        np.float32)
    out = []
    for cls, am in ((JaxScorer, jam), (PTMParityScorer, pam)):
        sc = cls(am.gauden, am.mixw, am.mdef.sen2cimap, max_topn=topn)
        out.append((sc.score_utt(feats), sc.top_cw.copy(), sc.top_sc.copy()))
    for a, b in zip(out[0], out[1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    scores = out[1][0]
    assert scores.dtype == np.int16 and (scores.min(axis=1) == 0).all()
    assert len(np.unique(scores)) > 50


def test_read_mixw_float_equal_jax(task):
    d, spec, _ = task
    hmm = spec.write_model_dir(str(d / "hmm"))
    path = os.path.join(hmm, "mixture_weights")
    for floor in (1e-7, 1e-3):
        a, b = jax_read_mixw(path, floor), read_mixw_float(path, floor)
        assert a.dtype == b.dtype and a.shape == b.shape == (
            spec.mixw.shape[2], spec.mixw.shape[0], spec.mixw.shape[1])
        np.testing.assert_array_equal(b, a)
