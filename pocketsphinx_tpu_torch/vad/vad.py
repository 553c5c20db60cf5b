"""Voice activity detection (ps_vad_t equivalent, include/pocketsphinx/
vad.h + src/ps_vad.c).  A copy of `pocketsphinx_tpu.vad.vad` (host code).

The reference wraps the vendored WebRTC GMM VAD (src/common_audio/vad).
This class keeps the exact ``ps_vad_t`` semantics:

- ``sample_rate`` may be arbitrary; the classifier runs at the closest
  supported rate (relative difference < 0.5, src/ps_vad.c:91-110) and
  the frame size is computed at that closest rate — the audio is simply
  *treated* as being at the closest rate, never resampled.
- decisions come from :class:`~pocketsphinx_tpu_torch.vad.webrtc.VadCore`,
  a bit-exact integer reimplementation of the WebRTC GMM VAD, verified
  frame-for-frame against the reference across all 4 modes x 3 frame
  lengths x 4 rates.
"""

from __future__ import annotations

import numpy as np

from .webrtc import VadCore, valid_rate_and_frame_length

# Modes (include/pocketsphinx/vad.h:62-70)
LOOSE = 0
MEDIUM_LOOSE = 1
MEDIUM_STRICT = 2
STRICT = 3

DEFAULT_SAMPLE_RATE = 16000
DEFAULT_FRAME_LENGTH = 0.03

_SUPPORTED_RATES = (8000, 16000, 32000, 48000)


class Vad:
    def __init__(self, mode: int = LOOSE,
                 sample_rate: int = DEFAULT_SAMPLE_RATE,
                 frame_length: float = DEFAULT_FRAME_LENGTH):
        if not sample_rate:
            sample_rate = DEFAULT_SAMPLE_RATE
        if not frame_length:
            frame_length = DEFAULT_FRAME_LENGTH
        # closest supported rate by relative difference (ps_vad.c:103-110)
        closest, best_diff = 0, 0.5
        for r in _SUPPORTED_RATES:
            diff = abs(1.0 - r / sample_rate)
            if diff < best_diff:
                closest, best_diff = r, diff
        if closest == 0:
            raise ValueError(
                f"No suitable sampling rate found for {sample_rate}")
        frame_size = int(closest * frame_length)
        if not valid_rate_and_frame_length(closest, frame_size):
            raise ValueError(f"Unsupported frame length {frame_length}")
        self.mode = mode
        self.sample_rate = sample_rate
        self.closest_sample_rate = closest
        self.frame_size = frame_size
        # ps_vad_frame_length (vad.h:178): frame_size over the *requested*
        # rate, so endpointer timestamps stay in the caller's time base.
        self.frame_length = frame_size / sample_rate
        self._core = VadCore(mode)

    def classify(self, frame) -> bool:
        """One frame of int16 PCM (exactly frame_size samples) ->
        speech/not-speech (ps_vad_classify)."""
        frame = np.asarray(frame)
        if frame.dtype != np.int16:
            frame = frame.astype(np.int16)
        if len(frame) != self.frame_size:
            raise ValueError(
                f"frame must be {self.frame_size} samples, got {len(frame)}")
        return self._core.process(self.closest_sample_rate, frame) > 0
