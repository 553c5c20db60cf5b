"""The port's legacy Python API (`compat`) against the JAX package's, over
one synthetic model directory, dictionary and LM (`synth.small_task`):
`Pocketsphinx.decode` of a WAV file, `AudioFile` over a file of
VAD-segmented bursts, `LiveSpeech` fed the same PCM in 0.1 s chunks, and
`Segmenter.segment_bytes`: hypotheses, segments (detailed), probability
and score exactly equal; `get_model_path` the same.  The port's decoders
score with the JAX scorer here (`same_costs`): the two scorers differ in
float32 summation order (within 2e-2 units, tests/test_torch_decoder.py),
and exact posteriors need the same costs."""

import wave

import numpy as np
import pytest
import torch

from pocketsphinx_tpu import compat as jax_compat
from pocketsphinx_tpu.models.acoustic import senone_scores_jax
from pocketsphinx_tpu_torch import compat
from pocketsphinx_tpu_torch import decoder as port_decoder
from pocketsphinx_tpu_torch.search import ngram_fused as port_fused
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import torch_one_thread  # noqa: F401


def write_wav(path, pcm, rate=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(pcm, "<i2").tobytes())


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("compat")
    hmm, dic, lmf = synth.small_task(str(d / "task"), seed=7)
    write_wav(d / "one.wav", synth.make_pcm(91, 1.5))
    live = synth.bursts_pcm(52, 3.0)
    write_wav(d / "live.wav", live)
    return d, dict(hmm=hmm, dict=dic, lm=lmf), live


def same_costs(monkeypatch, jax_am):
    """Make the port's decoders score with the JAX scorer of `jax_am`."""
    def scores(model, feats, topn=4, time_chunk=None, ds=1):
        x = feats.cpu().numpy() if torch.is_tensor(feats) else feats
        return torch.as_tensor(np.array(senone_scores_jax(
            jax_am.scoring_arrays, jax_am.cb_groups,
            np.asarray(x, np.float32), topn=topn, ds=ds)))
    for mod in (port_decoder, port_fused):
        monkeypatch.setattr(mod, "senone_scores", scores)


def _result(ps):
    return (ps.hypothesis(), ps.segments(detailed=True), ps.probability(),
            ps.score(), ps.segments())


def test_pocketsphinx_decode_equal_jax(task, monkeypatch):
    d, kw, _ = task
    jps = jax_compat.Pocketsphinx(**kw)
    same_costs(monkeypatch, jps.am)
    pps = compat.Pocketsphinx(device="cpu", **kw)
    got = [_result(ps.decode(str(d / "one.wav"))) for ps in (jps, pps)]
    assert got[1] == got[0]
    assert got[1][0] and got[1][2] < 1.0


def test_audiofile_equal_jax(task, monkeypatch):
    d, kw, _ = task
    path = str(d / "live.wav")
    jaf = jax_compat.AudioFile(path, **kw)
    same_costs(monkeypatch, jaf.am)
    got = [[_result(ps) for ps in af]
           for af in (jaf, compat.AudioFile(path, device="cpu", **kw))]
    assert got[1] == got[0]
    assert len(got[1]) >= 2


def test_livespeech_equal_jax(task, monkeypatch):
    _, kw, pcm = task
    chunks = lambda: (pcm[i:i + 1600].tobytes()  # noqa: E731
                      for i in range(0, len(pcm), 1600))
    jls = jax_compat.LiveSpeech(source=chunks(), **kw)
    same_costs(monkeypatch, jls.am)
    got = [[_result(ps) for ps in ls] for ls in (
        jls, compat.LiveSpeech(source=chunks(), device="cpu", **kw))]
    assert got[1] == got[0]
    assert len(got[1]) >= 2


def test_segmenter_equal_jax(task, monkeypatch):
    _, _, pcm = task
    data = pcm.astype("<i2").tobytes()
    got = [list(mod.Segmenter(sample_rate=16000).segment_bytes(data))
           for mod in (jax_compat, compat)]
    assert got[1] == got[0] and len(got[1]) >= 2
    monkeypatch.setenv("POCKETSPHINX_PATH", "/models")
    assert compat.get_model_path("en-us") == \
        jax_compat.get_model_path("en-us") == "/models/en-us"
