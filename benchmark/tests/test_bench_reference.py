"""The reference (`psref`, the frozen plain copy) agrees with the port on
the CPU at the tiny shape, and holds no way to run a kernel."""

import tempfile

import numpy as np
import pytest

from benchmark.harness import traffic
from benchmark.harness.cells import ROOT
from benchmark.harness.task import prepare
from conftest import DATA

PSREF = ROOT / "benchmark" / "reference" / "psref"


def test_psref_loads_no_kernel():
    text = "\n".join(p.read_text() for p in PSREF.rglob("*.py"))
    assert "CDLL" not in text and "nvcc" not in text
    assert "import pocketsphinx_tpu" not in text
    assert not list(PSREF.rglob("*.cu"))


@pytest.fixture(scope="module")
def task():
    import json
    conf = json.loads((DATA / "tiny.json").read_text())
    conf["name"] = "tiny"
    with tempfile.TemporaryDirectory() as d:
        yield conf, prepare(conf, 31, d)


def _decoders(conf, t, pkg):
    import importlib
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    am = m("models.acoustic").AcousticModel.load(t["hmm"])
    d = m("fileio.dictionary").Dictionary(am.mdef, t["dict"], t["noisedict"])
    lm = m("lm.ngram").read_lm(t["lm"], lw=conf["lw"], wip=conf["wip"])
    dec = m("search.ngram_fused").NgramFusedDecoder(
        am, m("models.dict2pid").Dict2Pid(am.mdef, d), lm, device="cpu")
    fe = m("frontend.mfcc").MelFrontend(**conf["frontend"])
    return dec, fe, m("frontend.feat").compute_feats


def test_batch_decode_equal(task):
    conf, t = task
    pcms = traffic.utterances({"median_s": 1.3, "sigma": 0.3, "min_s": 1.0,
                               "max_s": 2.0}, 3, seed=8)
    n = max(len(p) for p in pcms)
    pcm = np.zeros((3, n), np.float32)
    for i, p in enumerate(pcms):
        pcm[i, :len(p)] = p
    ns = np.array([len(p) for p in pcms], np.int32)
    outs = []
    for pkg in ("pocketsphinx_tpu_torch", "benchmark.reference.psref"):
        dec, fe, feats_of = _decoders(conf, t, pkg)
        cep, nf = fe.process_batch(pcm, ns, device="cpu")
        out = dec.decode_batch(feats_of(cep, nf, cmn="batch"), nf,
                               keep_records=False)
        outs.append(([(h, [(s.word, s.start, s.end) for s in sg])
                      for h, sg in out], list(dec.hyp_scores)))
    assert outs[0] == outs[1]
    assert any(h for h, _ in outs[0][0])


def test_stream_equal(task):
    from benchmark.harness.stream import _utterance
    from benchmark.reference.psref.decoder import Decoder as Ref
    from pocketsphinx_tpu_torch import Decoder
    conf, t = task
    pcm = traffic.utterances({"median_s": 1.5, "sigma": 0.1, "min_s": 1.0,
                              "max_s": 2.0}, 1, seed=9)[0]
    outs = []
    for cls in (Decoder, Ref):
        dec = cls(hmm=t["hmm"], dict=t["dict"], lm=t["lm"], lw=conf["lw"],
                  wip=conf["wip"], device="cpu")
        outs.append(_utterance(dec, pcm, dec.get_cmn(), 1600, 3)[0])
    assert outs[0] == outs[1]
    assert outs[0]["partials"] and outs[0]["segs"]
