"""The Sphinx-II semi-continuous 5-state model on the port's batch path:

  * the plain fan step at 5 states (`fan_step_ref`, which the fan kernel
    is held to on the card) equals the JAX scan's XLA finals block (its
    `hmm_step_sm` step as that block applies it) after the subtraction
    of `m_prev`, with forced ties, pad columns and a strided exit plane;
  * the batched s2_4x features (`compute_feats_s2_4x`) at B=3 with
    unequal lengths equal the benchmark reference's bit for bit, and the
    JAX package's per-utterance `compute_feats_typed(feat_type="s2_4x")`
    on each utterance's frames within the frontend's 1e-4;
  * the batch path takes its feature type from the model directory's
    feat.params, and refuses a type it does not make;
  * `decode_corpus` on a seeded semi-continuous 5-state s2_4x model
    (one codebook of 16 codewords, streams 12/24/3/12) gives the
    hypotheses and segments of the JAX package's per-utterance decode of
    the same PCM."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pocketsphinx_tpu.frontend.feat import compute_feats_typed as jax_feats
from pocketsphinx_tpu.ops.hmm import hmm_step_sm as jax_hmm_step_sm
from pocketsphinx_tpu_torch.frontend import feat as port_feat
from pocketsphinx_tpu_torch.ops import fan
from pocketsphinx_tpu_torch.search.ngram_fused import NgramFusedDecoder
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(nfilt=25, lowerf=130, upperf=6800, transform="dct",
           lifter_val=22, remove_noise=True)        # en-us feat.params
SECONDS = (1.1, 0.8, 1.3, 0.9, 1.2)


def _reference_s2_4x():
    path = ROOT / "benchmark" / "reference" / "feat" / "s2_4x.py"
    spec = importlib.util.spec_from_file_location("bench_ref_s2_4x", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_finals(S, TF, CX, pre, lp, tp_fin, pred, ptf, pcx):
    """The JAX scan's XLA finals block, batched: the costs of each final
    diphone `pre` [B, NST, NRC, LP] spread to the words by `lp` [W], its
    `hmm_step_sm` step of the carry S/TF/CX [B, NST, NRC, W] under
    `tp_fin` [W, NST, NST+1], the chain-last entry pred/ptf/pcx [B, W]
    into state 0 on a strict '>', and each word's first maximal exit.
    Returns (new S, TF, CTX [B, NST, NRC, W], the exit plane [B, NRC, W],
    exit score, TF, CTX [B, W]) as NumPy."""
    def states(x):
        return tuple(jnp.moveaxis(jnp.asarray(x.numpy()), 1, 0))
    sen = tuple(-x for x in states(pre[..., lp.long()]))
    newS, (nTF, nCX), out, _, (oTF, oCX) = jax_hmm_step_sm(
        states(S), sen, jnp.asarray(tp_fin.numpy()),
        metas=(states(TF), states(CX)))
    win = jnp.asarray(pred.numpy())[:, None] > newS[0]
    firsts = [jnp.where(win, jnp.asarray(x.numpy())[:, None], n[0])
              for x, n in ((pred, newS), (ptf, nTF), (pcx, nCX))]
    new = [np.stack([f] + [np.asarray(x) for x in n[1:]], 1)
           for f, n in zip(firsts, (newS, nTF, nCX))]
    am = jnp.argmax(out, axis=1)[:, None]            # the first maximal rc
    exits = [jnp.max(out, axis=1)] + [jnp.take_along_axis(x, am, 1)[:, 0]
                                      for x in (oTF, oCX)]
    return new, np.asarray(out), [np.asarray(x) for x in exits]


@pytest.mark.parametrize("offsets", ["zero", "mixed"])
@pytest.mark.parametrize("shape", [(11, 257, 37), (3, 7, 5)])
def test_fan_step_ref_5_states_equals_finals_block(shape, offsets):
    """At 5 states the plain fan step on a padded carry with offsets
    equals the JAX scan's XLA finals block on the carry's real columns
    less the offsets: new carry, exit plane (written into a strided
    view), exits; its pads are dead, and its partial maxima give the max
    of the new scores."""
    NRC, W, LP = shape
    rng = np.random.default_rng(31)
    a = {k: torch.as_tensor(v) for k, v in chip_smoke.fan_inputs(
        rng, 3, NRC, W, LP, ties=True, NST=5).items()}
    a["S"][:, 2, :, W - 1] = 0.0
    a["S"][..., W:] = 7.0                    # pads no result may read
    m = torch.as_tensor(chip_smoke.m_prev_inputs(rng, 3, offsets))
    buf = torch.full((3, NRC, W + 6), 2.5)
    got = fan.fan_step(**a, out_f=buf[:, :, 4:4 + W], m_prev=m)

    fin, out, exits = _jax_finals(
        a["S"][..., :W] - m[:, None, None, None], a["TF"][..., :W],
        a["CX"][..., :W], a["pre"], a["lp"][:W],
        a["tp"][:, :W].T.reshape(W, 5, 6), a["pred"], a["ptf"], a["pcx"])
    for i, k in enumerate(("S", "TF", "CTX")):
        np.testing.assert_array_equal(got[i][..., :W].numpy(), fin[i],
                                      err_msg=k)
        assert got[i].numpy().dtype == fin[i].dtype, k
    assert bool((got[0][..., W:] == fan.NEG_INF).all())
    assert not got[1][..., W:].any() and not got[2][..., W:].any()
    np.testing.assert_array_equal(buf[:, :, 4:4 + W].numpy(), out)
    assert bool((buf[:, :, :4] == 2.5).all())
    assert bool((buf[:, :, 4 + W:] == 2.5).all())
    for x, y in zip(got[4:7], exits, strict=True):
        np.testing.assert_array_equal(x.numpy(), y)
        assert x.numpy().dtype == y.dtype
    assert torch.equal(got[7].amax(1), got[0][..., :W].amax(dim=(1, 2, 3)))


def _ceps(lens, seed):
    """Padded cepstra [3, T, 13] of `lens` frames, c0 of either sign."""
    rng = np.random.default_rng(seed)
    cep = np.zeros((len(lens), max(lens), 13), np.float32)
    for b, n in enumerate(lens):
        cep[b, :n] = rng.normal(0, 4, (n, 13))
        cep[b, :n, 0] += rng.normal(1, 3)
    return cep


@pytest.mark.parametrize("cmn", ["batch", "none"])
def test_s2_4x_batched_equals_references(cmn):
    lens = [23, 9, 4]
    cep = _ceps(lens, 33)
    got = port_feat.compute_feats_s2_4x(torch.as_tensor(cep),
                                        torch.as_tensor(lens), cmn=cmn)
    want = _reference_s2_4x().features(torch.as_tensor(cep),
                                       torch.as_tensor(lens), cmn)
    assert got.shape == (3, 23, 4, 24)
    assert torch.equal(got, want)
    for f, width in enumerate(synth.S2_4X):
        assert not got[:, :, f, width:].any()
    for b, n in enumerate(lens):
        ref, featlen = jax_feats(cep[b, :n], feat_type="s2_4x", cmn=cmn)
        assert featlen == list(synth.S2_4X)
        np.testing.assert_allclose(got[b, :n].numpy(), ref, rtol=0,
                                   atol=1e-4)


def test_batch_features_by_type():
    assert port_feat.batch_features("1s_c_d_dd", port_feat.EN_US_SVSPEC) \
        is port_feat.compute_feats
    assert port_feat.batch_features() is port_feat.compute_feats
    assert port_feat.batch_features("s2_4x") is \
        port_feat.compute_feats_s2_4x
    for ft, sv in (("1s_c_d_ld_dd", None), ("1s_c_d_dd", "0-38"),
                   ("s2_4x", "0-11/12-35/36-38/39-50")):
        with pytest.raises(ValueError, match=f"-feat {ft}"):
            port_feat.batch_features(ft, sv)


@pytest.fixture(scope="module")
def semi_task(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("semi5"))
    dic = d + "/small.dic"
    words = synth.small_dictionary(dic, n_words=30, n_single=3, seed=11)
    lmf = synth.write_arpa(words, d + "/small.arpa", seed=12)
    spec = synth.make_semi_model([dic], seed=13, n_sen=210 + 400,
                                 n_density=16)
    hmm = spec.write_model_dir(d + "/hmm")
    pcms = [synth.make_pcm(70 + i, s).astype(np.float32)
            for i, s in enumerate(SECONDS)]
    return hmm, dic, lmf, pcms


def _port_decoder(hmm, dic, lmf):
    from pocketsphinx_tpu_torch.fileio.dictionary import Dictionary
    from pocketsphinx_tpu_torch.lm.ngram import read_lm
    from pocketsphinx_tpu_torch.models.acoustic import AcousticModel
    from pocketsphinx_tpu_torch.models.dict2pid import Dict2Pid
    am = AcousticModel.load(hmm)
    d2p = Dict2Pid(am.mdef, Dictionary(am.mdef, dic, hmm + "/noisedict"))
    return NgramFusedDecoder(am, d2p, read_lm(lmf, lw=6.5, wip=0.65),
                             topk=16, device="cpu")


def _key(results):
    return [(h, [(s.word, int(s.start), int(s.end)) for s in segs])
            for h, segs in results]


def test_semi5_model_directory(semi_task):
    hmm, dic, lmf, _ = semi_task
    pt = _port_decoder(hmm, dic, lmf)
    am = pt.am
    assert am.model_type == "semi" and pt.NST == 5
    assert (am.gauden.n_mgau, am.gauden.n_density) == (1, 16)
    assert list(am.gauden.featlen) == list(synth.S2_4X)
    assert am.feat_params == dict(feat="s2_4x", svspec=None, cmn="live")
    assert pt.init_carry(1)["fin"]["S"].shape[-1] == fan.padded_width(
        pt.n_multi)


def test_decode_corpus_semi5_equals_jax_per_utterance(semi_task):
    """The batch path (no feature option given: s2_4x from feat.params)
    at batch_size 3 equals the JAX package's decode of each utterance
    alone: its frontend, s2_4x features with batch CMN, scoring and
    search; every frame's word-final block is the fan step."""
    from pocketsphinx_tpu.fileio.dictionary import Dictionary as JDict
    from pocketsphinx_tpu.frontend.mfcc import MelFrontend as JaxFrontend
    from pocketsphinx_tpu.lm.ngram import read_lm as jax_read_lm
    from pocketsphinx_tpu.models.acoustic import AcousticModel as JaxAM
    from pocketsphinx_tpu.models.dict2pid import Dict2Pid as JD2P
    from pocketsphinx_tpu.search.ngram_fused import \
        NgramFusedDecoder as JaxFused
    from pocketsphinx_tpu_torch import profile
    from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend
    from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline
    hmm, dic, lmf, pcms = semi_task
    pt = _port_decoder(hmm, dic, lmf)
    pipe = BatchDecodePipeline(pt, MelFrontend(**CFG))
    assert pipe.features is port_feat.compute_feats_s2_4x
    before = profile.counters()
    got = _key(pipe.decode_corpus(pcms, batch_size=3))
    after = profile.counters()
    assert after["scan.finals_kernel"] > before.get("scan.finals_kernel", 0)

    jam = JaxAM.load(hmm)
    jx = JaxFused(jam, JD2P(jam.mdef, JDict(jam.mdef, dic,
                                            hmm + "/noisedict")),
                  jax_read_lm(lmf, lw=6.5, wip=0.65), topk=16)
    jfe = JaxFrontend(**CFG)
    want = []
    for pcm in pcms:
        feats, _ = jax_feats(jfe.process(pcm), feat_type="s2_4x",
                             cmn="batch")
        want.append(jx.decode(feats))
    assert got == _key(want)
    assert sum(bool(h) for h, _ in got) >= 3
