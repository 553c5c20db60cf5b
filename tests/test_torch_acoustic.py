"""The port's senone scoring, fed the JAX package's own scoring arrays
through `convert.scoring_tensors`, agrees with `senone_scores_jax` for
the block-diagonal PTM branch and the one-codebook-per-senone (CB == S)
branch, with topn 0 and 4, chunked and not.

Tolerance: both are float32 and take their GEMM and log-sum sums in a
different order; the costs are in shifted log units (log base 1.0001
>> 10, ~0.1 nat) with magnitudes up to a few thousand, so a relative
float32 error of ~1e-6 on the summed log densities gives up to ~1e-2
units.  The bound is 2e-2 absolute + 1e-5 relative."""

import numpy as np
import pytest
import torch

from pocketsphinx_tpu.models.acoustic import (AcousticModel as JaxModel,
                                              senone_scores_jax)
from pocketsphinx_tpu_torch.convert import scoring_tensors
from pocketsphinx_tpu_torch.models.acoustic import (AcousticModel,
                                                    senone_scores)
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import jax_model

ATOL, RTOL = 2e-2, 1e-5


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("am")
    dic = str(d / "small.dic")
    synth.small_dictionary(dic, n_words=30)
    spec = synth.make_model([dic], seed=2, n_sen=126 + 300, n_density=32)
    jam, _ = jax_model(spec, str(d / "jax"))
    tam, _ = spec.load(str(d / "torch"))
    return jam, tam


def _feats(seed, B=2, T=37):
    return np.random.default_rng(seed).standard_normal(
        (B, T, 3, 13)).astype(np.float32)


@pytest.mark.parametrize("topn", [0, 4])
@pytest.mark.parametrize("time_chunk", [None, 16])
def test_ptm_scores_match_jax(models, topn, time_chunk):
    jam, tam = models
    assert isinstance(jam, JaxModel) and isinstance(tam, AcousticModel)
    feats = _feats(topn)
    want = np.asarray(senone_scores_jax(jam.scoring_arrays, jam.cb_groups,
                                        feats, topn=topn,
                                        time_chunk=time_chunk))
    # the JAX model's own arrays, carried over
    got = senone_scores(scoring_tensors(jam.scoring_arrays, jam.cb_groups,
                                        "cpu"), torch.as_tensor(feats),
                        topn=topn, time_chunk=time_chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # and the port model built from the same files gives the same arrays
    for k, v in jam.scoring_arrays.items():
        np.testing.assert_array_equal(tam.scoring_arrays[k], v, err_msg=k)


@pytest.mark.parametrize("topn", [0, 4])
def test_continuous_scores_match_jax(topn):
    """CB == S: one codebook per senone (fully continuous models)."""
    rng = np.random.default_rng(5)
    S, F, D, L = 24, 3, 8, 13
    prec = rng.uniform(0.5, 2.0, (S, F, D, L)).astype(np.float32) / 64
    mu = rng.standard_normal((S, F, D, L)).astype(np.float32)
    arrays = dict(prec=prec, muprec=(mu * prec).astype(np.float32),
                  const=-(mu * mu * prec).sum(-1).astype(np.float32),
                  w_lin=np.exp(-rng.integers(0, 100, (F, D, S))
                               * 0.1).astype(np.float32))
    feats = _feats(9)
    want = np.asarray(senone_scores_jax(arrays, None, feats, topn=topn))
    got = senone_scores(scoring_tensors(arrays, None, "cpu"),
                        torch.as_tensor(feats), topn=topn)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_downsampled_scores_hold_frames(models):
    _, tam = models
    feats = torch.as_tensor(_feats(3, B=1, T=10))
    st = tam.scoring_tensors("cpu")
    full = senone_scores(st, feats[:, ::2])
    ds = senone_scores(st, feats, ds=2)
    np.testing.assert_array_equal(ds[:, ::2].numpy(), full.numpy())
    np.testing.assert_array_equal(ds[:, 1::2].numpy(), full.numpy())
