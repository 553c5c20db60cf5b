"""The port's host copies `fileio/sound.py`, `wer.py` and `evalcorpus.py`
give the JAX package's results: `read_audio` on 16-bit WAV (mono,
stereo, odd chunk padding), NIST and raw input and its errors,
`align_words` / `wer` on seeded word lists, and `build_corpus` on a
small stand-in of the reference's test-data tree."""

import wave

import numpy as np
import pytest

from pocketsphinx_tpu import evalcorpus as jax_evalcorpus
from pocketsphinx_tpu import wer as jax_wer
from pocketsphinx_tpu.fileio.sound import read_audio as jax_read_audio
from pocketsphinx_tpu_torch import evalcorpus, wer
from pocketsphinx_tpu_torch.fileio.sound import read_audio
from pocketsphinx_tpu_torch.testing import synth


def _wav(path, pcm, rate=16000, nch=1, extra=b""):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(pcm, "<i2").tobytes())
    if extra:            # an odd-sized chunk after the data chunk
        data = bytearray(open(path, "rb").read())
        data += b"LIST" + np.array([len(extra)], "<u4").tobytes() + extra
        data += b"\0" * (len(extra) & 1)
        data[4:8] = np.array([len(data) - 8], "<u4").tobytes()
        open(path, "wb").write(bytes(data))
    return path


def _nist(path, pcm, rate):
    hdr = (f"NIST_1A\n   1024\nsample_rate -i {rate}\n"
           f"sample_count -i {len(pcm)}\nend_head\n").encode()
    open(path, "wb").write(hdr.ljust(1024, b" ")
                           + np.asarray(pcm, "<i2").tobytes())
    return path


def _files(d):
    pcm = synth.make_pcm(5, 0.3)
    stereo = np.stack([pcm, -pcm], 1).reshape(-1)
    raw = d / "x.raw"
    raw.write_bytes(pcm.tobytes() + b"\x01")        # odd byte dropped
    return [_wav(d / "m.wav", pcm), _wav(d / "s.wav", stereo, 8000, 2),
            _wav(d / "o.wav", pcm, extra=b"abc"), _nist(d / "n.sph", pcm,
                                                        8000), raw]


def test_read_audio_equal(tmp_path):
    for path in _files(tmp_path):
        (a, ra), (b, rb) = read_audio(str(path), 11025), \
            jax_read_audio(str(path), 11025)
        assert ra == rb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert read_audio(str(tmp_path / "s.wav"))[1] == 8000
    assert read_audio(str(tmp_path / "x.raw"), 11025)[1] == 11025


def test_read_audio_errors(tmp_path):
    good = open(_wav(tmp_path / "m.wav", np.zeros(8)), "rb").read()
    (tmp_path / "nodata.wav").write_bytes(good[:36])
    bad = bytearray(good)
    bad[34:36] = np.array([8], "<u2").tobytes()     # 8-bit samples
    (tmp_path / "b8.wav").write_bytes(bytes(bad))
    for name, msg in (("b8.wav", "16-bit"), ("nodata.wav", "no data")):
        for fn in (read_audio, jax_read_audio):
            with pytest.raises(ValueError, match=msg):
                fn(str(tmp_path / name))


@pytest.mark.parametrize("seed", range(4))
def test_wer_equal(seed):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(12)]
    refs = [list(rng.choice(vocab, rng.integers(0, 15))) for _ in range(20)]
    hyps = [list(rng.choice(vocab, rng.integers(0, 15))) for _ in range(20)]
    for r, h in zip(refs, hyps):
        assert wer.align_words(r, h) == jax_wer.align_words(r, h)
    assert wer.wer(refs, hyps) == jax_wer.wer(refs, hyps)
    assert wer.wer([["a", "b"]], [["a", "b"]])["wer"] == 0.0


def test_build_corpus_equal(tmp_path):
    lib = tmp_path / "test" / "data" / "librivox"
    lib.mkdir(parents=True)
    for i, words in enumerate(("one two three", "four five", "six",
                               "seven eight", "nine ten eleven")):
        _wav(lib / f"clip{i}.wav", synth.make_pcm(40 + i, 0.4 + 0.1 * i))
        (lib / f"clip{i}.txt").write_text(words + "\n")
    (tmp_path / "test" / "data" / "goforward.raw").write_bytes(
        synth.make_pcm(50, 0.5).tobytes())
    a = evalcorpus.build_corpus(str(tmp_path), min_words=40)
    b = jax_evalcorpus.build_corpus(str(tmp_path), min_words=40)
    assert len(a) == len(b) > 4
    for (na, pa, wa), (nb, pb, wb) in zip(a, b):
        assert (na, wa) == (nb, wb)
        np.testing.assert_array_equal(pa, pb)
    assert evalcorpus.TARGET_WORDS == jax_evalcorpus.TARGET_WORDS
