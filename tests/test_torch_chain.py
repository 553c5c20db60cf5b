"""The port's plain chain step (pocketsphinx_tpu_torch.ops.chain.
chain_step_ref, which `chain_step` runs for CPU tensors) is bit-equal to
the JAX package's Pallas chain kernel run in interpret mode, with and
without variants, batched; its folded per-diphone gather (`fd_idx`)
equals the JAX scan's one-hot expansion of the variant planes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pocketsphinx_tpu.ops.pallas_chain import chain_step as jax_chain_step
from pocketsphinx_tpu_torch.ops import chain

B = 3


def _mk(rng, NST, D, W, RF, NFD):
    return dict(
        S=(rng.standard_normal((B, NST, D, W)) * 30).astype(np.float32),
        TF=rng.integers(0, 99, (B, NST, D, W)).astype(np.int32),
        CTX=rng.integers(0, 999, (B, NST, D, W)).astype(np.int32),
        VAR=rng.integers(0, RF, (B, NST, W)).astype(np.int32),
        pre=(rng.random((B, NST, D, W)) * 80).astype(np.float32),
        prevd=(rng.random((B, NST, RF, NFD)) * 80).astype(np.float32),
        fd_idx=rng.integers(0, NFD, W).astype(np.int32),
        tp=-(rng.random((NST * (NST + 1), D, W)) * 5).astype(np.float32),
        fm=np.arange(D)[:, None] == rng.integers(0, D, W)[None, :],
        nv=rng.integers(1, RF + 1, W).astype(np.int32))


def _jax(a, has_var, prevd_w):
    """The Pallas kernel under vmap over the batch (interpret mode)."""
    pip = np.float32(-0.7)
    fn = lambda s, tf, cx, vr, pr, pv: jax_chain_step(  # noqa: E731
        s, tf, cx, vr if has_var else None, pr, pv if has_var else None,
        jnp.asarray(a["tp"]), jnp.asarray(a["fm"]), jnp.asarray(a["nv"]),
        pip, interpret=True)
    return jax.vmap(fn)(*[jnp.asarray(x) for x in
                          (a["S"], a["TF"], a["CTX"], a["VAR"], a["pre"],
                           prevd_w)])


@pytest.mark.parametrize("NST,D,W,RF", [(3, 6, 200, 4), (5, 3, 130, 2)])
@pytest.mark.parametrize("has_var", [True, False])
def test_chain_step_ref_matches_pallas(NST, D, W, RF, has_var):
    a = _mk(np.random.default_rng(7 + NST), NST, D, W, RF, NFD=W)
    a["fd_idx"] = np.arange(W, dtype=np.int32)     # per-word variant planes
    ref = _jax(a, has_var, a["prevd"])
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    if not has_var:
        t["VAR"] = t["prevd"] = t["fd_idx"] = t["nv"] = None
    got = chain.chain_step(pip=float(np.float32(-0.7)), **t)
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                      err_msg=f"output {i}")


def test_chain_fd_idx_gather_equals_jax_expansion():
    """prevd per first diphone [B, NST, RF, NFD] gathered by fd_idx ==
    the JAX scan's oh_matmul("jvf,fw->jvw", prev_d, fd_oh) expansion
    (search/ngram_fused.py, chain block) feeding the Pallas kernel."""
    NST, D, W, RF, NFD = 3, 5, 170, 3, 23
    a = _mk(np.random.default_rng(3), NST, D, W, RF, NFD)
    fd_oh = (a["fd_idx"][None, :] == np.arange(NFD)[:, None]).astype(
        np.float32)
    prevd_w = jax.vmap(lambda p: jnp.einsum(
        "jvf,fw->jvw", p, jnp.asarray(fd_oh),
        precision=jax.lax.Precision.HIGHEST))(jnp.asarray(a["prevd"]))
    ref = _jax(a, True, prevd_w)
    got = chain.chain_step(pip=float(np.float32(-0.7)),
                           **{k: torch.as_tensor(v) for k, v in a.items()})
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                      err_msg=f"output {i}")


def test_chain_step_refuses_batched_tables():
    a = {k: torch.as_tensor(v) for k, v in
         _mk(np.random.default_rng(4), 3, 4, 50, 2, 9).items()}
    a["tp"] = a["tp"][None].expand(B, *a["tp"].shape).contiguous()
    with pytest.raises(ValueError, match="tp"):
        chain.chain_step(pip=0.0, **a)
