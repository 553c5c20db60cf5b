"""The JAX package's counterparts of the port's synthetic test objects.

The port's `testing.synth` builds only port objects.  The parity tests
build the JAX package's model and decoder here, from the same files
(`SynthModel.write`) and the same arrays, so both packages get one model.
"""

import os

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
