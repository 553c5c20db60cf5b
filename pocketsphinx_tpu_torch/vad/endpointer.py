"""Utterance endpointing (ps_endpointer_t, src/ps_endpointer.c).

A copy of `pocketsphinx_tpu.vad.endpointer` (host code).

Exact-semantics reimplementation of the reference endpointer: a ring
buffer of VAD-labeled frames.  Speech starts when strictly more than
``int(ratio * maxlen)`` frames of the window are speech, and ends when
fewer than ``int((1 - ratio) * maxlen + 0.5)`` are
(src/ps_endpointer.c:78-80, :398-434).  While in speech, each
``process`` call emits exactly ONE frame — the oldest queued one — so
output is delayed by up to ``window`` seconds but no audio is lost and
segments can never overlap (src/ps_endpointer.c:401-420).  Timestamps
follow ``qstart_time``: the stream time of the head of the queue.
"""

from __future__ import annotations

import numpy as np

from .vad import Vad, DEFAULT_FRAME_LENGTH

DEFAULT_WINDOW = 0.3
DEFAULT_RATIO = 0.9


class Endpointer:
    def __init__(self, window: float = DEFAULT_WINDOW,
                 ratio: float = DEFAULT_RATIO, vad_mode: int = 0,
                 sample_rate: int = 16000,
                 frame_length: float = DEFAULT_FRAME_LENGTH):
        if not window:
            window = DEFAULT_WINDOW
        if not ratio:
            ratio = DEFAULT_RATIO
        self.vad = Vad(vad_mode, sample_rate, frame_length)
        self.frame_size = self.vad.frame_size
        self.frame_length = self.vad.frame_length
        self.sample_rate = self.vad.sample_rate
        # src/ps_endpointer.c:78-80
        self.maxlen = int(window / self.frame_length + 0.5)
        self.start_frames = int(ratio * self.maxlen)
        self.end_frames = int((1.0 - ratio) * self.maxlen + 0.5)
        if not (0 < self.start_frames < self.maxlen):
            raise ValueError(
                f"Ratio {ratio} makes start-pointing impossible "
                f"({self.start_frames} frames of {self.maxlen})")
        if not (0 < self.end_frames < self.maxlen):
            raise ValueError(
                f"Ratio {ratio} makes end-pointing impossible "
                f"({self.end_frames} frames of {self.maxlen})")
        self.reset()

    def reset(self):
        # queue of (frame, is_speech); head = oldest (= ep->pos)
        self._queue: list[tuple[np.ndarray, bool]] = []
        self._speech_count = 0
        self.in_speech = False
        self.speech_start = 0.0
        self.speech_end = 0.0
        self._qstart_time = 0.0       # stream time of the queue head
        self._timestamp = 0.0         # last_audio_timestamp

    @property
    def timestamp(self) -> float:
        return self._timestamp

    # -- ring buffer ops (ep_push/ep_pop, src/ps_endpointer.c:209-255) ----

    def _push(self, frame: np.ndarray, is_speech: bool):
        if len(self._queue) == self.maxlen:
            _, old = self._queue.pop(0)
            if old:
                self._speech_count -= 1
            self._qstart_time += self.frame_length
        self._queue.append((frame, is_speech))
        if is_speech:
            self._speech_count += 1

    def _pop(self) -> np.ndarray:
        frame, is_speech = self._queue.pop(0)
        if is_speech:
            self._speech_count -= 1
        self._qstart_time += self.frame_length
        return frame

    # -- public API (mirrors ps_endpointer_process / _end_stream) ---------

    def process(self, frame: np.ndarray):
        """One frame in -> one frame out or None.  Exactly
        ps_endpointer_process (src/ps_endpointer.c:370-440): while in
        speech each call returns the oldest queued frame; on the
        transition out of speech the final frame is returned with
        ``in_speech`` already False."""
        frame = np.asarray(frame, dtype=np.int16)
        if len(frame) != self.frame_size:
            raise ValueError(
                f"frame must be {self.frame_size} samples, got {len(frame)}")
        is_speech = self.vad.classify(frame)
        self._push(frame.copy(), is_speech)
        self._timestamp += self.frame_length
        if self.in_speech:
            if self._speech_count < self.end_frames:
                pcm = self._pop()
                self.speech_end = self._qstart_time
                self.in_speech = False
                return pcm
        else:
            if self._speech_count > self.start_frames:
                self.speech_start = self._qstart_time
                self.speech_end = 0.0
                self.in_speech = True
        if self.in_speech:
            return self._pop()
        return None

    def end_stream(self, frame=None):
        """Flush at end of input (ps_endpointer_end_stream,
        src/ps_endpointer.c:291-368): emits the remaining prefix of
        queued speech frames, plus the trailing partial frame if the
        whole queue was speech."""
        if not self.in_speech:
            return None
        self.in_speech = False
        self.speech_end = self._qstart_time
        out = []
        while self._queue:
            is_speech = self._queue[0][1]
            pcm = self._pop()
            if is_speech:
                out.append(pcm)
                self.speech_end = self._qstart_time
            else:
                break
        if not self._queue and frame is not None and len(frame) \
                and self.speech_end == self._qstart_time:
            frame = np.asarray(frame, dtype=np.int16)
            self._timestamp += len(frame) / self.sample_rate
            out.append(frame)
            self.speech_end = self._timestamp
        self._queue.clear()
        self._speech_count = 0
        return np.concatenate(out) if out else None

    # -- convenience ---------------------------------------------------------

    def segment(self, pcm: np.ndarray):
        """Whole-buffer segmentation: yields (start_sec, end_sec,
        speech_pcm) utterances (the Segmenter class of the reference's
        python package), built on the exact per-frame semantics."""
        pcm = np.asarray(pcm, dtype=np.int16)
        fs = self.frame_size
        cur: list[np.ndarray] = []
        start = 0.0
        for i in range(0, len(pcm) - fs + 1, fs):
            prev_in_speech = self.in_speech
            out = self.process(pcm[i:i + fs])
            if out is not None:
                if not prev_in_speech:
                    start = self.speech_start
                cur.append(out)
                if not self.in_speech:
                    yield (start, self.speech_end, np.concatenate(cur))
                    cur = []
        tail = pcm[len(pcm) - (len(pcm) % fs):] if len(pcm) % fs else None
        prev_in_speech = self.in_speech
        out = self.end_stream(tail)
        if out is not None:
            if not prev_in_speech:
                start = self.speech_start
            cur.append(out)
        if cur:
            yield (start, self.speech_end, np.concatenate(cur))
