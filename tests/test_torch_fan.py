"""The port's plain fan step (pocketsphinx_tpu_torch.ops.fan.fan_step_ref,
which `fan_step` runs for CPU tensors) is bit-equal to the JAX package's
Pallas fan kernel run in interpret mode; batched inputs share lp/tp."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pocketsphinx_tpu.ops.pallas_fan import fan_step as jax_fan_step
from pocketsphinx_tpu_torch.ops import fan

NAMES = ["S", "TF", "CX", "out_f", "esc", "etf", "ecx"]


def _mk(rng, B, NRC, W, LP, ties):
    # the input style of tests/test_pallas_fan.py, with a batch axis
    S = rng.uniform(-50, 0, (B, 3, NRC, W)).astype(np.float32)
    pred = rng.uniform(-50, 0, (B, W)).astype(np.float32)
    tp = rng.uniform(-12, 0, (12, W)).astype(np.float32)
    if ties:
        S, pred, tp = np.round(S), np.round(pred), np.round(tp)
    S[:, 0, :, : W // 7] = -1e30
    pred[:, ::5] = -1e30
    tp[3] = -1e30
    return dict(
        S=S, TF=rng.integers(0, 400, (B, 3, NRC, W)).astype(np.int32),
        CX=rng.integers(0, 1 << 20, (B, 3, NRC, W)).astype(np.int32),
        pred=pred, ptf=rng.integers(0, 400, (B, W)).astype(np.int32),
        pcx=rng.integers(0, 1 << 20, (B, W)).astype(np.int32),
        pre=rng.uniform(0, 60, (B, 3, NRC, LP)).astype(np.float32),
        lp=rng.integers(0, LP, W).astype(np.int32), tp=tp)


def _torch(a):
    return {k: torch.as_tensor(v) for k, v in a.items()}


@pytest.mark.parametrize("shape", [(11, 257, 37), (41, 640, 601)])
@pytest.mark.parametrize("ties", [False, True])
def test_fan_step_ref_matches_pallas(shape, ties):
    NRC, W, LP = shape
    a = _mk(np.random.default_rng(7 if ties else 3), 1, NRC, W, LP, ties)
    ref = jax_fan_step(*[jnp.asarray(a[k][0]) for k in
                         ("S", "TF", "CX", "pred", "ptf", "pcx", "pre")],
                       jnp.asarray(a["lp"]), jnp.asarray(a["tp"]),
                       interpret=True)
    got = fan.fan_step(**_torch(a))          # CPU tensors: the plain version
    for n, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(np.asarray(r), g[0].numpy(), err_msg=n)


def test_fan_step_batched_shared_lp_tp():
    B, NRC, W, LP = 3, 9, 150, 23
    a = _mk(np.random.default_rng(11), B, NRC, W, LP, ties=True)
    ref = jax.vmap(lambda *x: jax_fan_step(
        *x, jnp.asarray(a["lp"]), jnp.asarray(a["tp"]), interpret=True))(
        *[jnp.asarray(a[k]) for k in
          ("S", "TF", "CX", "pred", "ptf", "pcx", "pre")])
    got = fan.fan_step_ref(**_torch(a))
    for n, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(), err_msg=n)


@pytest.mark.parametrize("key", ["lp", "tp"])
def test_fan_step_refuses_batched_lp_tp(key):
    a = _torch(_mk(np.random.default_rng(1), 2, 5, 40, 7, ties=False))
    a[key] = a[key][None].expand(2, *a[key].shape).contiguous()
    with pytest.raises(ValueError, match=key):
        fan.fan_step(**a)


def test_fan_step_refuses_wrong_dtype_and_counts_nothing_on_cpu():
    a = _torch(_mk(np.random.default_rng(2), 1, 5, 40, 7, ties=False))
    fan.reset_launches()
    fan.fan_step(**a)
    assert fan.launches == 0                 # the CPU runs the plain version
    a["TF"] = a["TF"].to(torch.int64)
    with pytest.raises(TypeError, match="TF"):
        fan.fan_step(**a)
