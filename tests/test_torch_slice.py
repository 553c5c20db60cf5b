"""The slice end to end: seeded PCM -> MFCC -> features -> senone costs ->
fused n-gram scan -> backtrace -> hypothesis, through both packages on
the same synthetic model, dictionary and LM, at B=3 with unequal lengths.

  * costs from each package's own frontend and scoring agree within
    0.2 units (shifted log units, magnitudes ~200): the features differ
    by up to the frontend tolerances (2e-3 cepstra, 1e-4 features) and
    float32 sums run in another order (measured max 0.055 at these
    seeds);
  * the port's search on the JAX costs equals the JAX search exactly;
  * the port's end-to-end hypotheses equal the JAX package's at these
    seeds."""

import numpy as np
import pytest
import torch

from pocketsphinx_tpu.frontend.feat import compute_feats_jax
from pocketsphinx_tpu.frontend.mfcc import MelFrontend as JaxFrontend
from pocketsphinx_tpu.models.acoustic import senone_scores_jax
from pocketsphinx_tpu_torch.frontend.feat import compute_feats
from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend
from pocketsphinx_tpu_torch.models.acoustic import senone_scores
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import jax_decoder, torch_one_thread  # noqa: F401

CFG = dict(nfilt=25, lowerf=130, upperf=6800, transform="dct",
           lifter_val=22, remove_noise=True)        # en-us feat.params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("slice"))
    dic = d + "/small.dic"
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=1)
    lmf = synth.write_arpa(words, d + "/small.arpa", seed=2)
    spec = synth.make_model([dic], seed=3, n_sen=126 + 300, n_density=16)
    jx = jax_decoder(spec, d, dic, lmf, topk=16)
    pt = synth.build_decoder(spec, d, dic, lmf, topk=16, device="cpu")
    pcms = [synth.make_pcm(s, sec) for s, sec in ((21, 1.2), (22, 0.8),
                                                  (23, 1.5))]
    pcm = np.zeros((3, max(map(len, pcms))), np.float32)
    for i, p in enumerate(pcms):
        pcm[i, :len(p)] = p
    ns = np.array([len(p) for p in pcms], np.int32)

    cep, nf = JaxFrontend(**CFG).process_batch_jax(pcm, ns)
    fj = np.asarray(compute_feats_jax(cep, nf))
    nf = np.asarray(nf)
    cj = np.array(senone_scores_jax(jx.am.scoring_arrays, jx.am.cb_groups,
                                    fj, time_chunk=16))
    oj = jx.decode_batch(fj, nf, keep_records=False)
    jax_out = (oj, list(jx.hyp_scores), list(jx.guard_violations_batch))

    cept, nft = MelFrontend(**CFG).process_batch(pcm, ns, device="cpu")
    ft = compute_feats(cept, nft)
    ct = senone_scores(pt.am.scoring_tensors("cpu"), ft, time_chunk=16)
    op = pt.decode_batch(ft, nft, keep_records=False)
    port_out = (op, list(pt.hyp_scores), list(pt.guard_violations_batch))
    return dict(pt=pt, nf=nf, nft=nft, cj=cj, ct=ct.numpy(), jax=jax_out,
                port=port_out)


def _hyps(out):
    return [(h, [(s.word, s.start, s.end) for s in segs]) for h, segs in out]


def test_costs_agree(runs):
    np.testing.assert_array_equal(runs["nft"].numpy(), runs["nf"])
    for b, n in enumerate(runs["nf"]):
        np.testing.assert_allclose(runs["ct"][b, :n], runs["cj"][b, :n],
                                   atol=0.2, rtol=0)


def test_port_search_on_jax_costs_is_exact(runs):
    pt = runs["pt"]
    out = pt.decode_batch(None, runs["nf"], keep_records=False,
                          costs=torch.as_tensor(runs["cj"]))
    oj, scores, viol = runs["jax"]
    assert _hyps(out) == _hyps(oj)
    assert pt.hyp_scores == scores
    assert pt.guard_violations_batch == viol


def test_end_to_end_hypotheses_equal(runs):
    op, oj = runs["port"][0], runs["jax"][0]
    assert [h for h, _ in op] == [h for h, _ in oj]
    assert all(h for h, _ in op)
