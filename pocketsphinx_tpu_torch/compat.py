"""Legacy Python API compatibility layer, mirroring the reference's
cython/pocketsphinx/__init__.py so users can switch imports:
get_model_path, Pocketsphinx, AudioFile, LiveSpeech, Segmenter.

Port of `pocketsphinx_tpu.compat` over the port's `Decoder`: a `device`
keyword (CUDA unless `device="cpu"`) reaches the decoder.
"""

from __future__ import annotations

import os

import numpy as np

from .decoder import Decoder
from .fileio.sound import read_audio
from .vad.endpointer import Endpointer


def get_model_path(subpath: str | None = None) -> str:
    """Model directory resolution: POCKETSPHINX_PATH, else the model
    directory of the reference checkout named by PS_REFERENCE, else
    "model"."""
    root = os.environ.get("POCKETSPHINX_PATH")
    if root is None:
        ref = os.environ.get("PS_REFERENCE")
        cand = os.path.join(ref, "model") if ref else ""
        root = cand if cand and os.path.isdir(cand) else "model"
    return os.path.join(root, subpath) if subpath else root


class Pocketsphinx(Decoder):
    """Deprecated-style convenience decoder (cython/pocketsphinx/
    __init__.py:95-177)."""

    def __init__(self, device=None, **kwargs):
        kwargs.setdefault("hmm", get_model_path("en-us/en-us"))
        if "lm" not in kwargs and "jsgf" not in kwargs \
                and "fsg" not in kwargs and "keyphrase" not in kwargs:
            lm = get_model_path("en-us/en-us.lm.bin")
            if os.path.isfile(lm):
                kwargs["lm"] = lm
        kwargs.setdefault("dict", get_model_path("en-us/cmudict-en-us.dict"))
        super().__init__(device=device, **kwargs)

    def start_utterance(self):
        self.start_utt()

    def end_utterance(self):
        self.end_utt()

    def decode(self, audio_file, buffer_size=2048, no_search=False,
               full_utt=False):
        pcm, _ = read_audio(audio_file, self.config["samprate"])
        self.decode_raw(pcm)
        return self

    def segments(self, detailed=False):
        if detailed:
            return [(s.word, s.prob, s.start_frame, s.end_frame)
                    for s in self.seg_iter()]
        return [s.word for s in self.seg_iter()]

    def hypothesis(self) -> str:
        h = self.hyp()
        return h.hypstr if h else ""

    def probability(self):
        h = self.hyp()
        return h.prob if h else 0.0

    def score(self):
        h = self.hyp()
        return h.score if h else 0

    def best(self, count=10):
        return self.nbest(count)

    def confidence(self):
        return self.probability()


class AudioFile(Pocketsphinx):
    """Iterate over VAD-segmented utterances of an audio file."""

    def __init__(self, audio_file=None, **kwargs):
        self._audio_file = audio_file or kwargs.pop("audio_file", None)
        super().__init__(**kwargs)

    def __iter__(self):
        pcm, _ = read_audio(self._audio_file, self.config["samprate"])
        ep = Endpointer(sample_rate=self.config["samprate"])
        for start, end, speech in ep.segment(pcm):
            self.start_utt()
            self.process_raw(speech)
            self.end_utt()
            yield self


class Segmenter(Endpointer):
    """cython/pocketsphinx/segmenter.py equivalent: yields
    (start, end, pcm-bytes) speech segments."""

    def segment_bytes(self, data: bytes):
        pcm = np.frombuffer(data, dtype="<i2")
        for start, end, speech in self.segment(pcm):
            yield start, end, speech.tobytes()


class LiveSpeech(Pocketsphinx):
    """Stream from a callable source (no audio hardware in this build;
    pass `source=` a generator of PCM chunks)."""

    def __init__(self, source=None, **kwargs):
        self._source = source
        super().__init__(**kwargs)

    def __iter__(self):
        if self._source is None:
            raise RuntimeError("LiveSpeech requires a source= generator "
                               "of int16 PCM chunks in this build")
        ep = Endpointer(sample_rate=self.config["samprate"])
        buf = np.zeros(0, np.int16)
        cur: list[np.ndarray] = []
        fs = ep.frame_size
        for chunk in self._source:
            pcm = np.frombuffer(chunk, dtype="<i2") if isinstance(
                chunk, (bytes, bytearray)) else np.asarray(chunk, np.int16)
            buf = np.concatenate([buf, pcm])
            while len(buf) >= fs:
                out = ep.process(buf[:fs])
                buf = buf[fs:]
                if out is not None:
                    cur.append(out)
                if not ep.in_speech and cur:
                    self.start_utt()
                    self.process_raw(np.concatenate(cur))
                    self.end_utt()
                    cur = []
                    yield self
        tail = ep.end_stream()
        if tail is not None:
            cur.append(tail)
        if cur:
            self.start_utt()
            self.process_raw(np.concatenate(cur))
            self.end_utt()
            yield self
