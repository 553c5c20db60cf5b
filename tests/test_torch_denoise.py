"""The port's noise removal (`frontend.mfcc.noise_removal`, its gains
recurrence `ops.denoise.gains`) against the JAX package's
`noise_removal_jax` on seeded mel spectra of unequal lengths (the frames
past each length zero, as `process_batch` gives them, so the zero-power
guard runs too).  The denoised spectra agree in the log domain that the
cepstra are taken from within the frontend tests' 2e-3
(tests/test_torch_frontend.py); the gains run on the CPU through the
plain loop, and `process_batch` reaches them through the wrapper once
per batch with `remove_noise` and never without."""

import numpy as np
import pytest
import torch

from pocketsphinx_tpu.frontend.mfcc import noise_removal_jax
from pocketsphinx_tpu_torch.frontend import mfcc
from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend, noise_removal
from pocketsphinx_tpu_torch.ops import _build, denoise
from pocketsphinx_tpu_torch.testing.synth import make_pcm
from _torch_jax_helpers import torch_one_thread  # noqa: F401


def seeded_mfspec(B, T, nfilt, lengths, seed):
    """Mel power spectra [B, T, nfilt]: log-normal energies over a slow
    per-filter level (speech-like swings of several decades), zero past
    each utterance's length."""
    rng = np.random.default_rng(seed)
    level = rng.uniform(2.0, 8.0, (B, 1, nfilt))
    swing = np.cumsum(rng.normal(0.0, 0.3, (B, T, 1)), axis=1)
    x = 10.0 ** (level + np.clip(swing, -3, 3)
                 + rng.normal(0.0, 0.5, (B, T, nfilt)))
    x[np.arange(T)[None, :] >= np.asarray(lengths)[:, None]] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("B,T,nfilt,lengths", [
    (3, 37, 40, [37, 20, 5]),
    (4, 123, 25, [123, 77, 1, 100]),
    (1, 3, 25, [3]),
])
def test_noise_removal_matches_jax(B, T, nfilt, lengths):
    x = seeded_mfspec(B, T, nfilt, lengths, seed=T)
    want = np.asarray(noise_removal_jax(x, np.asarray(lengths, np.int32)))
    got = noise_removal(torch.tensor(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(np.log(got[b, :n] + mfcc.LOG_FLOOR),
                                   np.log(want[b, :n] + mfcc.LOG_FLOOR),
                                   atol=2e-3, rtol=0)
    # the whole tensor, frames past the lengths included, stays finite
    assert np.isfinite(got).all()


def test_gains_plain_on_cpu(monkeypatch):
    """A CPU tensor takes the plain loop, which never builds the kernel;
    the gains lie in [1/MAX_GAIN, MAX_GAIN] and are given for every
    frame."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(name))
    x = torch.tensor(seeded_mfspec(2, 30, 25, [30, 12], seed=2))
    g = denoise.gains(x)
    assert g.shape == x.shape and g.dtype == torch.float32
    assert float(g.min()) >= np.float32(1 / denoise.MAX_GAIN)
    assert float(g.max()) <= denoise.MAX_GAIN
    assert torch.equal(g, denoise.gains_ref(x))
    assert denoise.gains(x[:, :0]).shape == (2, 0, 25)
    with pytest.raises(TypeError):
        denoise.gains(x.double())
    with pytest.raises(ValueError):
        denoise.gains(x[0])


def test_consts_are_torch_float32():
    """The kernel's constants are the float32 values torch applies: each
    rounded from the Python double, (1 - lambda) in double first."""
    for v, c in zip([0.7, 1 - 0.7, 0.995, 1 - 0.995, 0.5, 1 - 0.5, 0.85,
                     0.2, 20.0, 1 / 20.0, 1e-30], denoise.CONSTS):
        assert np.float32(v) == c
        assert torch.tensor(v, dtype=torch.float32).item() == float(c)


@pytest.mark.parametrize("remove_noise", [True, False])
def test_process_batch_routes_through_wrapper(monkeypatch, remove_noise):
    calls = []

    def spy(m):
        calls.append(tuple(m.shape))
        return denoise.gains_ref(m)

    monkeypatch.setattr(denoise, "gains", spy)
    fe = MelFrontend(nfilt=25, lowerf=130, upperf=6800, transform="dct",
                     lifter_val=22, remove_noise=remove_noise)
    pcm = np.zeros((2, 12000), np.float32)
    pcm[0] = make_pcm(3, 0.75)
    pcm[1, :8000] = make_pcm(4, 0.5)
    cep, nf = fe.process_batch(pcm, np.array([12000, 8000]), device="cpu")
    assert calls == ([(2, cep.shape[1], 25)] if remove_noise else [])
