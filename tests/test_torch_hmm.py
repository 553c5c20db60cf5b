"""The port's HMM step (pocketsphinx_tpu_torch.ops.hmm) is bit-equal to
the JAX package's on random planes with forced ties, 3- and 5-state."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pocketsphinx_tpu.ops import hmm as jhmm
from pocketsphinx_tpu_torch.ops import hmm as thmm


def _planes(rng, N, shape):
    # integer-valued scores and transitions force equal candidates
    S = np.round(rng.uniform(-20, 0, (N,) + shape)).astype(np.float32)
    S[:, ::5] = -1e30
    sen = np.round(rng.uniform(-6, 0, (N,) + shape)).astype(np.float32)
    tp = np.round(rng.uniform(-6, 0, shape + (N, N + 1))).astype(np.float32)
    tp[..., 0, N] = -1e30
    metas = [rng.integers(0, 1 << 20, (N,) + shape).astype(np.int32)
             for _ in range(2)]
    return S, sen, tp, metas


@pytest.mark.parametrize("N", [3, 5])
def test_hmm_step_sm_bit_equal(N):
    rng = np.random.default_rng(N)
    S, sen, tp, metas = _planes(rng, N, (7, 33))
    j = jhmm.hmm_step_sm(tuple(jnp.asarray(x) for x in S),
                         tuple(jnp.asarray(x) for x in sen), jnp.asarray(tp),
                         metas=[tuple(jnp.asarray(x) for x in m)
                                for m in metas])
    t = thmm.hmm_step_sm(tuple(torch.as_tensor(x) for x in S),
                         tuple(torch.as_tensor(x) for x in sen),
                         torch.as_tensor(tp),
                         metas=[tuple(torch.as_tensor(x) for x in m)
                                for m in metas])
    for a, b in zip(j[0], t[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for ma, mb in zip(j[1], t[1]):
        for a, b in zip(ma, mb):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for i in (2, 3):
        np.testing.assert_array_equal(np.asarray(j[i]), t[i].numpy())
    for a, b in zip(j[4], t[4]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("N", [3, 5])
def test_hmm_step_and_meta_bit_equal(N):
    rng = np.random.default_rng(10 + N)
    S, sen, tp, metas = _planes(rng, N, (4, 21))
    S, sen = np.moveaxis(S, 0, -1), np.moveaxis(sen, 0, -1)
    meta = np.moveaxis(metas[0], 0, -1)
    j = jhmm.hmm_step(jnp.asarray(S), jnp.asarray(sen), jnp.asarray(tp))
    t = thmm.hmm_step(torch.as_tensor(S), torch.as_tensor(sen),
                      torch.as_tensor(tp))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        np.asarray(jhmm.propagate_meta(jnp.asarray(meta), j[1])),
        thmm.propagate_meta(torch.as_tensor(meta), t[1]).numpy())
    np.testing.assert_array_equal(
        np.asarray(jhmm.out_meta(jnp.asarray(meta), j[3])),
        thmm.out_meta(torch.as_tensor(meta), t[3]).numpy())
