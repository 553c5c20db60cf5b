"""The port's batched frontend (MFCC with noise removal, then batch-CMN
dynamic features) agrees with the JAX package's on seeded PCM batches of
unequal lengths, within the tolerances of tests/test_frontend.py: 2e-3
on cepstra and 1e-4 on features.  Both are float32 with a different sum
order (FFT, filterbank and DCT products, the CMN mean)."""

import numpy as np
import pytest
import torch

from pocketsphinx_tpu.frontend.feat import compute_feats_jax
from pocketsphinx_tpu.frontend.mfcc import MelFrontend as JaxFrontend
from pocketsphinx_tpu_torch.frontend.feat import compute_feats
from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend
from pocketsphinx_tpu_torch.testing.synth import make_pcm

CFG = dict(nfilt=25, lowerf=130, upperf=6800, transform="dct",
           lifter_val=22, remove_noise=True)        # en-us feat.params


def _batch(seeds, seconds):
    pcms = [make_pcm(s, sec) for s, sec in zip(seeds, seconds)]
    out = np.zeros((len(pcms), max(map(len, pcms))), np.float32)
    for i, p in enumerate(pcms):
        out[i, :len(p)] = p
    return out, np.array([len(p) for p in pcms], np.int32)


@pytest.mark.parametrize("remove_noise", [True, False])
def test_mfcc_and_features_match_jax(remove_noise):
    cfg = dict(CFG, remove_noise=remove_noise)
    pcm, ns = _batch([4, 5, 6], [0.8, 1.7, 1.2])
    cep_j, nf_j = JaxFrontend(**cfg).process_batch_jax(pcm, ns)
    cep_t, nf_t = MelFrontend(**cfg).process_batch(pcm, ns, device="cpu")
    np.testing.assert_array_equal(np.asarray(nf_j), nf_t.numpy())
    cep_j = np.asarray(cep_j)
    for b, n in enumerate(nf_t.numpy()):
        np.testing.assert_allclose(cep_t[b, :n].numpy(), cep_j[b, :n],
                                   atol=2e-3, rtol=0)
    # features from the same cepstra: CMN + deltas
    f_j = np.asarray(compute_feats_jax(cep_j, nf_j, cmn="batch"))
    f_t = compute_feats(torch.tensor(cep_j), nf_t)
    for b, n in enumerate(nf_t.numpy()):
        np.testing.assert_allclose(f_t[b, :n].numpy(), f_j[b, :n],
                                   atol=1e-4, rtol=0)


def test_feature_shapes_and_edges():
    cep = torch.randn(2, 9, 13)
    f = compute_feats(cep, torch.tensor([9, 4]), cmn="none")
    assert f.shape == (2, 9, 3, 13)
    # replicated edges: the delta of a one-frame-long tail is zero there
    np.testing.assert_array_equal(f[1, 3, 1].numpy(),
                                  (cep[1, 3] - cep[1, 1]).numpy())
