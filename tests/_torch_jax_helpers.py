"""The JAX package's counterparts of the port's synthetic test objects.

The port's `testing.synth` builds only port objects.  The parity tests
build the JAX package's model and decoder here, from the same files
(`SynthModel.write`) and the same arrays, so both packages get one model.
"""

import os

import jax
import numpy as np
import pytest
import torch

from pocketsphinx_tpu.fileio import acoustic as fio
from pocketsphinx_tpu.fileio.bin_mdef import read_text_mdef
from pocketsphinx_tpu.fileio.dictionary import Dictionary
from pocketsphinx_tpu.lm.ngram import read_lm
from pocketsphinx_tpu.logmath import default_logmath
from pocketsphinx_tpu.models.acoustic import AcousticModel
from pocketsphinx_tpu.models.dict2pid import Dict2Pid
from pocketsphinx_tpu.search.ngram_fused import NgramFusedDecoder


def jax_model(spec, directory, varfloor=1e-4):
    """The JAX package's `AcousticModel` of a `synth.SynthModel`, built
    from the files it writes into `directory`.  Returns (model, path of
    the noise dictionary)."""
    mdef_path, noise_path = spec.write(directory)
    n_cb, n_feat, n_den, dim = spec.means.shape
    g = fio.Gauden(n_cb, n_feat, n_den, np.full(n_feat, dim, np.int32),
                   spec.means, spec.var)
    g.precompute(default_logmath(), varfloor)
    am = AcousticModel(
        mdef=read_text_mdef(mdef_path), gauden=g,
        mixw=fio.MixtureWeights(mixw=spec.mixw, n_sen=spec.mixw.shape[-1]),
        tmat=fio.Tmat(tp=spec.tmat), model_type="ptm")
    return am, noise_path


def jax_decoder(spec, workdir, dic, lmfile, lw=6.5, wip=0.65, **kw):
    """The JAX package's `NgramFusedDecoder` over the same model,
    dictionary and LM as `synth.build_decoder`."""
    am, noise = jax_model(spec, os.path.join(workdir, "jax_model"))
    d2p = Dict2Pid(am.mdef, Dictionary(am.mdef, dic, noise))
    return NgramFusedDecoder(am, d2p, read_lm(lmfile, lw=lw, wip=wip), **kw)


def model_pair(spec, directory, dic):
    """The same synthetic model and dictionary loaded into both packages:
    ((JAX AcousticModel, JAX Dict2Pid), (port AcousticModel, port
    Dict2Pid))."""
    from pocketsphinx_tpu_torch.fileio.dictionary import (
        Dictionary as PDictionary)
    from pocketsphinx_tpu_torch.models.dict2pid import Dict2Pid as PDict2Pid
    jam, noise = jax_model(spec, os.path.join(directory, "jax_model"))
    pam, pnoise = spec.load(os.path.join(directory, "port_model"))
    return ((jam, Dict2Pid(jam.mdef, Dictionary(jam.mdef, dic, noise))),
            (pam, PDict2Pid(pam.mdef, PDictionary(pam.mdef, dic, pnoise))))


def tie_costs(n_sen, T, seed, tie_frame=None):
    """Seeded costs [T, n_sen] with one frame where every senone costs the
    same (1e29), so that every score of that frame collapses onto one
    value and every max in the step ties."""
    c = np.random.default_rng(seed).uniform(0, 400, (T, n_sen)).astype(
        np.float32)
    c[T // 3 if tie_frame is None else tie_frame] = 1e29
    return c


def scan_outputs(monkeypatch):
    """A list that receives the (carry, stacked outputs) of every
    `jax.lax.scan` the JAX package runs from now on: the per-frame
    records of searches that keep none."""
    seen, scan = [], jax.lax.scan

    def spy(*a, **k):
        seen.append(scan(*a, **k))
        return seen[-1]

    monkeypatch.setattr(jax.lax, "scan", spy)
    return seen


def assert_records_equal(port, jax_recs, names):
    """Port records (tensors or arrays) equal the JAX ones bit for bit,
    dtype and shape included."""
    assert len(port) == len(jax_recs) == len(names)
    for n, a, b in zip(names, jax_recs, port):
        a = np.asarray(a)
        b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (n, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=n)


def dictionary_with_alternates(path, n_words=30, seed=0, n_alt=3):
    """`synth.small_dictionary` plus alternate pronunciations `w(2)` of its
    first `n_alt` multi-phone words (each the pronunciation of a later
    word).  Returns the base words."""
    from pocketsphinx_tpu_torch.testing import synth
    words = synth.small_dictionary(path, n_words=n_words, seed=seed)
    lines = open(path).read().splitlines()
    multi = [ln.split() for ln in lines if len(ln.split()) > 2]
    extra = [f"{a[0]}(2) " + " ".join(b[1:])
             for a, b in zip(multi[:n_alt], multi[-n_alt:])]
    with open(path, "a") as f:
        f.write("\n".join(extra) + "\n")
    return words


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """Run a module's torch CPU work on one intra-op thread.  The 6-worker
    test run puts several processes on the host's cores, and torch's
    default pool of one thread per core then oversubscribes them: the
    small ops of these tests wait on each other's spinning threads.  Import
    this fixture into a test module to use it; the thread count is
    restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
