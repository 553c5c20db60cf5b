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
    a = chip_smoke.to_device(chip_smoke.chain_inputs(
        np.random.default_rng(2), 3, NST, 6, 200, 4, 37, has_var, True),
        cuda)
    n = chain.launches
    outs = chain.chain_step(**a)
    assert chain.launches == n + 1
    chip_smoke.compare(outs, chain.chain_step_ref(**a), "chain")


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
