"""The port's forced aligner against the JAX package's, over a word
sequence with alternate pronunciations and a single-phone word, optional
silences and alternates each on and off: the phone graph equal node for
node, the per-frame backpointer records (int8 / uint8 / bool codes and
the renormalized exits) bit-equal on one seeded cost matrix with a frame
of forced ties, and the word, phone and state entries equal."""

from dataclasses import astuple

import pytest

from pocketsphinx_tpu.search.align import Aligner as JAligner
from pocketsphinx_tpu_torch.search.align import Aligner
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import (  # noqa: F401
    assert_records_equal, dictionary_with_alternates, model_pair,
    scan_outputs, tie_costs, torch_one_thread)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("align")
    dic = str(d / "alt.dic")
    words = dictionary_with_alternates(dic, n_words=20, seed=13)
    spec = synth.make_model([dic], seed=14, n_sen=126 + 300, n_density=8)
    # alternates first, a single-phone word inside, a repeated word
    text = [words[0], words[-1], words[1], words[5], words[2], words[5]]
    return model_pair(spec, str(d), dic), text


@pytest.mark.parametrize("use_silence", [True, False])
@pytest.mark.parametrize("use_altpron", [True, False])
def test_align_equal(task, use_silence, use_altpron, monkeypatch):
    ((jam, jd2p), (pam, pd2p)), text = task
    kw = dict(silprob=0.005, wip=0.65, lw=6.5, use_silence=use_silence,
              use_altpron=use_altpron)
    jx, pt = JAligner(jam, jd2p, **kw), Aligner(pam, pd2p, device="cpu",
                                                 **kw)
    gj, gp = jx.build_graph(text), pt.build_graph(text)
    assert [astuple(n) for n in gp] == [astuple(n) for n in gj]
    assert pt._final_frontier == jx._final_frontier
    assert any(n.is_sil for n in gp) == use_silence
    assert (len({n.wid for n in gp}) > len(set(text)) + use_silence) \
        == use_altpron
    costs = tie_costs(pam.n_sen, 150, seed=15)
    seen = scan_outputs(monkeypatch)
    ej = jx.align(None, text, costs=costs)
    bt = []
    monkeypatch.setattr(pt, "_backtrace", lambda *a: bt.append(a) or
                        Aligner._backtrace(pt, *a))
    ep = pt.align(None, text, costs=costs)
    assert_records_equal(bt[0][3:8], seen[-1][1],
                         "src osrc ewin esrc out".split())
    for level_p, level_j in zip(ep, ej):
        assert [astuple(e) for e in level_p] == [astuple(e) for e in level_j]
    words = [e.text for e in ep[0] if e.text != "<sil>"]
    assert [w.split("(")[0] for w in words] == text
    assert sum(e.duration for e in ep[0]) == 150


def test_unknown_word_raises(task):
    ((_, _), (pam, pd2p)), _ = task
    with pytest.raises(KeyError, match="Unknown word"):
        Aligner(pam, pd2p, device="cpu").build_graph(["nosuchword"])
