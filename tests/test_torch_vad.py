"""The port's WebRTC VAD and endpointer (`vad/`) against the JAX package's,
on seeded PCM of loud voiced bursts, quiet noise and digital silence
(`synth.bursts_pcm`), so that the decisions change within each run:

  * `VadCore.process` frame by frame at 8, 16, 32 and 48 kHz, 10, 20 and
    30 ms frames, modes 0-3: every decision equal (the 48 kHz quirk, the
    32 kHz filter-state split and the 16/32-bit wraps on the way);
  * `Vad` at 11,025, 22,050 and 44,100 Hz: the same closest rate, frame
    size, frame length and decisions, and the same errors;
  * `Endpointer`: the reference `live` read loop's event lines and
    emitted-sample checksum (tests/test_vad_parity.py's replay) at each
    rate, with and without a trailing partial frame, and `segment()`.
All equalities are exact."""

import numpy as np
import pytest

from pocketsphinx_tpu.vad import endpointer as jax_endpointer
from pocketsphinx_tpu.vad import vad as jax_vad
from pocketsphinx_tpu.vad import webrtc as jax_webrtc
from pocketsphinx_tpu_torch.testing import synth
from pocketsphinx_tpu_torch.vad import endpointer, vad, webrtc
from _torch_jax_helpers import torch_one_thread  # noqa: F401

RATES = (8000, 16000, 32000, 48000)
SECONDS = 1.0


def _pcm(rate, seed=3, seconds=SECONDS):
    return synth.bursts_pcm(seed, seconds, rate)


@pytest.mark.parametrize("mode", range(4))
@pytest.mark.parametrize("ms", (10, 20, 30))
@pytest.mark.parametrize("rate", RATES)
def test_vad_core_equal_jax(rate, ms, mode):
    pcm = _pcm(rate, seed=rate // 1000 + ms)
    fs = rate * ms // 1000
    out = []
    for mod in (jax_webrtc, webrtc):
        core = mod.VadCore(mode)
        out.append([core.process(rate, pcm[i:i + fs])
                    for i in range(0, len(pcm) - fs + 1, fs)])
    assert out[1] == out[0]
    assert {0, 1} <= set(out[1])            # the decisions change


@pytest.mark.parametrize("rate", (11025, 22050, 44100))
def test_vad_closest_rate_equal_jax(rate):
    pcm = _pcm(rate, seed=5, seconds=0.6)
    got = []
    for mod in (jax_vad, vad):
        v = mod.Vad(mod.MEDIUM_STRICT, rate, 0.02)
        fs = v.frame_size
        got.append((v.closest_sample_rate, v.frame_size, v.frame_length,
                    [v.classify(pcm[i:i + fs])
                     for i in range(0, len(pcm) - fs + 1, fs)]))
    assert got[1] == got[0]
    assert got[1][0] == {11025: 8000, 22050: 16000, 44100: 48000}[rate]
    for kw, match in ((dict(sample_rate=4000), "No suitable sampling rate"),
                      (dict(sample_rate=rate, frame_length=0.025),
                       "Unsupported frame length")):
        msgs = []
        for mod in (jax_vad, vad):
            with pytest.raises(ValueError, match=match) as e:
                mod.Vad(**kw)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
    msgs = []
    for mod in (jax_vad, vad):
        v = mod.Vad(sample_rate=rate)
        with pytest.raises(ValueError, match="frame must be") as e:
            v.classify(pcm[:10])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def _ep_events(cls, pcm, sr):
    """The reference `live` read loop over an endpointer: one line per
    emitted frame or flush (frame number, samples out, in-speech before
    and after, speech start and end) and the checksum of every emitted
    sample (tests/test_vad_parity.py's replay)."""
    ep = cls(sample_rate=sr)
    fs = ep.frame_size
    lines = []
    sm = 0
    fno = 0
    i = 0

    def emit(out, prev):
        nonlocal sm
        for v in out:
            sm = (sm * 31 + int(np.uint16(v))) & 0xFFFFFFFFFFFFFFFF
        lines.append(
            f"{fno} out={len(out)} prev={int(prev)} in={int(ep.in_speech)} "
            f"start={ep.speech_start:.4f} end={ep.speech_end:.4f}")

    while i + fs <= len(pcm):
        prev = ep.in_speech
        out = ep.process(pcm[i:i + fs])
        if out is not None:
            emit(out, prev)
        fno += 1
        i += fs
    tail = pcm[i:]
    if len(tail):
        prev = ep.in_speech
        out = ep.end_stream(tail)
        if out is not None:
            emit(out, prev)
    elif ep.in_speech:
        out = ep.end_stream(None)
        if out is not None:
            emit(out, True)
    lines.append(f"CHECKSUM {sm}")
    return lines


@pytest.mark.parametrize("tail", (False, True))
@pytest.mark.parametrize("rate", RATES)
def test_endpointer_equal_jax(rate, tail):
    pcm = _pcm(rate, seed=50, seconds=3.0)
    fs = rate * 3 // 100
    # end on a frame boundary, or a third of a frame past it
    pcm = pcm[:(len(pcm) // fs) * fs - (fs // 3 if tail else 0)]
    ev = [_ep_events(m.Endpointer, pcm, rate)
          for m in (jax_endpointer, endpointer)]
    assert ev[1] == ev[0]
    assert len(ev[1]) > 20                  # speech was found
    if tail:                                # `segment` flushes the tail
        segs = [[(s, e, p.tobytes()) for s, e, p in
                 m.Endpointer(sample_rate=rate).segment(pcm)]
                for m in (jax_endpointer, endpointer)]
        assert segs[1] == segs[0]
        assert len(segs[1]) == 2
