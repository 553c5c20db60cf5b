"""Tests of the port that need the card: the CUDA kernels against their
plain versions, and a small decode on CUDA against the same decode on the
CPU.  They skip without CUDA.  This file imports no JAX, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pocketsphinx_tpu_torch.ops import chain, fan
from pocketsphinx_tpu_torch.testing import synth

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.device("cuda")


@pytest.mark.parametrize("ties", [False, True])
def test_fan_kernel_bit_equal(cuda, ties):
    a = chip_smoke.to_device(chip_smoke.fan_inputs(
        np.random.default_rng(1), 3, 11, 257, 37, ties), cuda)
    n = fan.launches
    outs = fan.fan_step(**a)
    assert fan.launches == n + 1
    chip_smoke.compare(outs, fan.fan_step_ref(**a), "fan")


@pytest.mark.parametrize("NST,has_var", [(3, True), (3, False), (5, True)])
def test_chain_kernel_bit_equal(cuda, NST, has_var):
    a = chip_smoke.chain_inputs(np.random.default_rng(2), 3, NST, 6, 200,
                                4, 37, has_var, True)
    grp, args = chip_smoke.chain_group_args([a], cuda)
    n = chain.launches
    outs = chain.chain_group_step(grp, **args)
    assert chain.launches == n + 1
    torch.cuda.synchronize()
    chip_smoke.compare(outs, chain.chain_group_ref(grp, **args), "chain")


@pytest.mark.parametrize("B", [3, 11])
@pytest.mark.parametrize("NST,with_ci", [(3, True), (3, False), (5, True),
                                         (5, False)])
def test_chain_group_kernel_bit_equal(cuda, NST, with_ci, B):
    """One launch over variant buckets of several depths (and a CI
    bucket) equals the grouped plain version; B=11 runs the kernel's loop
    over batch rows past a block's 8."""
    buckets = [(NST, 5, 70, 4, 9, True), (NST, 16, 40, 3, 7, True),
               (NST, 2, 300, 2, 5, True)]
    if with_ci:
        buckets.append((NST, 4, 9, 0, 0, False))
    rng = np.random.default_rng(3)
    per = [chip_smoke.chain_inputs(rng, B, *bk, True) for bk in buckets]
    grp, args = chip_smoke.chain_group_args(per, cuda)
    n = chain.launches
    outs = chain.chain_group_step(grp, **args)
    assert chain.launches == n + 1
    torch.cuda.synchronize()
    chip_smoke.compare(outs, chain.chain_group_ref(grp, **args),
                       "chain group")


def test_decode_cuda_equals_cpu(cuda, tmp_path):
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=40)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=3)
    spec = synth.make_model([dic], seed=1, n_sen=126 + 300, n_density=8)
    dec = synth.build_decoder(spec, str(tmp_path), dic, lmf, topk=8,
                              device=cuda)
    costs = np.random.default_rng(5).uniform(0, 400, (50, dec.am.n_sen))
    costs = costs.astype(np.float32)
    hyp, segs = dec.decode(None, costs=costs)
    cpu = dec.to("cpu")
    hyp_c, segs_c = cpu.decode(None, costs=costs)
    for a, b in zip(dec.raw_records, cpu.raw_records):
        np.testing.assert_array_equal(a, b)
    assert (hyp, dec.hyp_score) == (hyp_c, cpu.hyp_score)
