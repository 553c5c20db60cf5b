"""Streaming frontend + feature state — the incremental seam of
fe_process_frames (overflow-sample carry, src/fe/fe_interface.c:352-520),
fe_remove_noise's running state, cmn live, and feat_s2mfc2feat_live's
Δ-window buffering (src/feat/feat.c:1310-1420).

A copy of `pocketsphinx_tpu.frontend.stream`.  Host-side NumPy:
streaming chunks are small and latency-bound, and the output is
bit-identical to the host whole-utterance path (`MelFrontend.process`,
`compute_feats_typed`); the batched device pipeline stays the
throughput path.
"""

from __future__ import annotations

import numpy as np

from .mfcc import MelFrontend, LOG_FLOOR, _lower_env, _smooth_gain, \
    LAMBDA_POWER, LAMBDA_T, MU_T, MAX_GAIN
from .feat import CmnLive, WIN


class FrontendStream:
    """Incremental PCM -> MFCC with carried state."""

    def __init__(self, fe: MelFrontend):
        self.fe = fe
        self.reset()

    def reset(self):
        self._carry = np.zeros(0, np.float64)   # unconsumed samples
        self._prior = 0.0                       # pre-emphasis carry
        self._noise = None                      # (power, noise, floor, peak)

    def process(self, pcm: np.ndarray, end: bool = False) -> np.ndarray:
        """Feed samples; returns any newly complete MFCC frames [n, ncep].
        With end=True, flushes the zero-padded tail frame (fe_end_utt)."""
        fe = self.fe
        x = np.concatenate([self._carry, np.asarray(pcm, np.float64)])
        frames = []
        pos = 0
        while pos + fe.frame_size <= len(x):
            frames.append(x[pos:pos + fe.frame_size])
            pos += fe.frame_shift
        tail_len = None
        if end and pos < len(x):
            tail = np.zeros(fe.frame_size)
            tail_len = len(x) - pos
            tail[:tail_len] = x[pos:]
            frames.append(tail)
            pos = len(x)
        self._carry = x[pos:]
        if not frames:
            return np.zeros((0, fe.ncep), np.float32)
        fr = np.stack(frames)
        # pre-emphasis with carried prior
        pe = np.empty_like(fr)
        for i, f in enumerate(fr):
            pe[i, 0] = f[0] - fe.alpha * self._prior
            pe[i, 1:] = f[1:] - fe.alpha * f[:-1]
            # prior for the NEXT frame = sample at frame_shift-1 of this
            # frame's raw window (fe_spch_to_frame)
            self._prior = f[min(fe.frame_shift, len(f)) - 1]
        if tail_len is not None:
            # zero padding is applied *after* pre-emphasis in the
            # reference's end-of-utterance flush (fe_spch_to_frame)
            pe[-1, tail_len:] = 0.0
        if fe.remove_dc:
            pe = pe - pe.mean(axis=1, keepdims=True)
        pe = pe * fe.window[None, :]
        spec = np.fft.rfft(pe, n=fe.nfft, axis=1)
        power = spec.real ** 2 + spec.imag ** 2
        mf = power @ fe.mel_fb.astype(np.float64)
        if fe.remove_noise:
            mf = self._denoise(mf)
        logspec = np.log(mf + LOG_FLOOR)
        cep = logspec @ fe.dct
        if fe.lifter is not None:
            cep = cep * fe.lifter[None, :]
        return cep.astype(np.float32)

    def _denoise(self, mfspec: np.ndarray) -> np.ndarray:
        out = np.empty_like(mfspec)
        if self._noise is None:
            first = mfspec[0]
            self._noise = (first.copy(), first / MAX_GAIN,
                           first / MAX_GAIN, np.zeros_like(first))
        power, noise, floor, peak = self._noise
        for t in range(len(mfspec)):
            x = mfspec[t]
            power = LAMBDA_POWER * power + (1 - LAMBDA_POWER) * x
            noise = _lower_env(power, noise)
            signal = np.maximum(power - noise, 1.0)
            floor = _lower_env(signal, floor)
            cur = signal.copy()
            peak = peak * LAMBDA_T
            signal = np.where(signal < LAMBDA_T * peak, peak * MU_T, signal)
            peak = np.where(cur > peak, cur, peak)
            signal = np.maximum(signal, floor)
            gain = np.where(signal < MAX_GAIN * power,
                            np.divide(signal, power,
                                      out=np.full_like(signal, MAX_GAIN),
                                      where=power > 0), MAX_GAIN)
            gain = np.maximum(gain, 1.0 / MAX_GAIN)
            out[t] = _smooth_gain(x, gain)
        self._noise = (power, noise, floor, peak)
        return out


class FeatStream:
    """Incremental MFCC -> feature frames with the live Δ-window buffer
    (feat_s2mfc2feat_live): the first frame is replicated `win` times at
    utterance start, the last `win` frames are held back until more
    input (or replicated at end).

    Supports every batch feature type (round-3 review missing #5): an
    output frame is emitted once its full ±win context is buffered,
    then computed by the shared compute_feats_typed kernel on the
    buffered segment — the segment's replicated-edge frames fall
    outside the emitted range, so streaming output is bit-identical to
    the batch computation with live CMN."""

    #: feat_window_size per type (src/feat/feat.c feat_init)
    _WINS = {"1s_c_d_dd": WIN, "s3_1x39": WIN, "1s_c_d": WIN,
             "cep_dcep": WIN, "1s_c": WIN, "cep": WIN,
             "1s_c_d_ld_dd": 4, "s2_4x": 4}

    def __init__(self, feat_type: str = "1s_c_d_dd",
                 svspec: str | None = "0-12/13-25/26-38",
                 cmn: str = "live", cmn_state: CmnLive | None = None):
        if feat_type not in self._WINS:
            raise ValueError(f"unsupported feature type {feat_type!r}")
        self.feat_type = feat_type
        self.win = self._WINS[feat_type]
        self.svspec = svspec if feat_type not in ("s2_4x",) else None
        self.cmn = cmn
        self.cmn_state = cmn_state or CmnLive()
        self.reset()

    def reset(self):
        self._buf = None
        self._begun = False

    def process(self, cep: np.ndarray, end: bool = False) -> np.ndarray:
        """Feed MFCC frames, get feature frames [n, F, L]."""
        from .feat import compute_feats_typed

        cep = np.asarray(cep, np.float32)
        win = self.win
        # Streaming always uses running-mean CMN — the reference's live
        # path applies cmn_live even under "-cmn batch" (feat_cmn only
        # uses batch CMN for whole-utterance blocks, feat.c:1344-1352).
        if len(cep) and self.cmn != "none":
            cep = self.cmn_state(cep)
        if self._buf is None:
            self._buf = np.zeros((0, cep.shape[1] if len(cep) else 13),
                                 np.float32)
        if len(cep) and not self._begun:
            self._buf = np.repeat(cep[:1], win, axis=0)
            self._begun = True
        if len(cep):
            self._buf = np.concatenate([self._buf, cep])
        if end and self._begun:
            self._buf = np.concatenate(
                [self._buf, np.repeat(self._buf[-1:], win, axis=0)])
        # frames computable: centers win..len-win-1 of the buffer
        n_out = len(self._buf) - 2 * win
        if n_out <= 0:
            out, _ = compute_feats_typed(
                np.zeros((1, self._buf.shape[1]), np.float32),
                feat_type=self.feat_type, svspec=self.svspec, cmn="none")
            return out[:0]
        feats, _ = compute_feats_typed(
            self._buf, feat_type=self.feat_type, svspec=self.svspec,
            cmn="none")
        out = feats[win:win + n_out]
        # keep the trailing 2*win frames for the next call
        self._buf = self._buf[n_out:]
        return out
