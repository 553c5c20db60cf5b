"""Signal frontend: PCM int16 -> MFCC, batched, in torch.

Port of `pocketsphinx_tpu.frontend.mfcc`: the host-side setup (mel
filterbank, DCT, lifter, window), the host float64 path that the
`Decoder` runs (`MelFrontend.process`, `mel_spectrum`, `from_config`,
`noise_removal_np`; NumPy copies), and the batched device path
`process_batch_jax` as `MelFrontend.process_batch` in torch.

Ground-up re-design of the reference DSP pipeline (src/fe/fe_sigproc.c,
fe_interface.c, fe_noise.c — float build: frame_t/powspec_t = float64,
mfcc_t = float32) as dense array ops:

    pre-emphasis (global y[t] = x[t] - a*x[t-1])
    -> framing [T, frame_size] (shift 160, size 410 @16k)
    -> optional DC removal -> Hamming window -> zero-pad to nfft
    -> rFFT -> power spectrum [T, nfft/2+1]
    -> mel filterbank matmul [T, nfilt]
    -> noise removal (Doblinger minima tracking; sequential scan over T)
    -> log(. + 1e-4) -> DCT matmul [T, ncep] -> liftering

The JAX package's NumPy path reproduces the reference float build
(float64 DSP, float32 filterbank coefficients and DCT cosines) and is the
parity anchor against
golden .mfc dumps in the JAX package; here `process_batch` is the
[B, N] device version (noise tracking as a loop over frames).

Equivalences to the reference (file:line):
  * frame/window params      fe_interface.c:60-130, fe.h:68-100
  * pre-emphasis w/ carry    fe_sigproc.c:727-755, 855-880 (prior =
    previous frame's sample at frame_shift-1 == global filter)
  * Hamming                  fe_sigproc.c:775-826
  * mel filterbank           fe_sigproc.c:537-686 (float32 freq math,
    round_filters, unit_area)
  * power spectrum           fe_sigproc.c:1162-1205
  * noise removal            fe_noise.c:65-364
  * log/DCT/lifter           fe_sigproc.c:1245-1363
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device

LOG_FLOOR = 1e-4

# Noise-suppression constants (fe_noise.c:65-74)
SMOOTH_WINDOW = 4
LAMBDA_POWER = 0.7
LAMBDA_A = 0.995
LAMBDA_B = 0.5
LAMBDA_T = 0.85
MU_T = 0.2
MAX_GAIN = 20.0


def make_warp(warp_type: str | None, warp_params: str | None):
    """VTLN frequency warp functions (src/fe/fe_warp*.c): returns
    (unwarped_to_warped, warped_to_unwarped) callables."""
    params = [float(x) for x in warp_params.split()] if warp_params else []
    if warp_type in (None, "", "none") or not params:
        return (lambda x: x), (lambda x: x)
    if warp_type == "affine":
        a = params[0]
        b = params[1] if len(params) > 1 else 0.0
        return (lambda x: a * x + b), (lambda x: (x - b) / a)
    if warp_type == "inverse_linear" or warp_type == "inverse":
        a = params[0]
        return (lambda x: x / a), (lambda x: x * a)
    if warp_type == "piecewise_linear":
        # warp by a below f0, continuous linear above (fe_warp_piecewise)
        a = params[0]
        f0 = params[1] if len(params) > 1 else 6800.0
        def fwd(x):
            return x * a if x < f0 else f0 * a + (x - f0)
        def inv(x):
            return x / a if x < f0 * a else f0 + (x - f0 * a)
        return fwd, inv
    raise ValueError(f"unknown warp type {warp_type!r}")


def _mel(hz: np.ndarray | float, warp=None) -> np.ndarray:
    if warp is not None:
        hz = warp(float(hz))
    return np.float32(2595.0 * np.log10(1.0 + np.float64(hz) / 700.0))


def _melinv(m: np.ndarray | float, unwarp=None) -> np.ndarray:
    hz = np.float32(700.0 * (np.power(10.0, np.float64(m) / 2595.0) - 1.0))
    if unwarp is not None:
        hz = np.float32(unwarp(float(hz)))
    return hz


def build_mel_filterbank(samprate: float, nfft: int, nfilt: int,
                         lowerf: float, upperf: float,
                         doublewide: bool = False,
                         round_filters: bool = True,
                         unit_area: bool = True,
                         warp_type: str | None = None,
                         warp_params: str | None = None) -> np.ndarray:
    """Dense triangular mel filterbank [nfft//2+1, nfilt] float32,
    reproducing fe_build_melfilters' float32 frequency arithmetic
    (with optional VTLN warping)."""
    warp, unwarp = make_warp(warp_type, warp_params)
    melmin = np.float32(_mel(lowerf, warp))
    melmax = np.float32(_mel(upperf, warp))
    melbw = np.float32((melmax - melmin) / np.float32(nfilt + 1))
    if doublewide:
        melmin = np.float32(melmin - melbw)
        melmax = np.float32(melmax + melbw)
    fftfreq = np.float32(np.float32(samprate) / np.float32(nfft))
    n_bins = nfft // 2 + 1
    fb = np.zeros((n_bins, nfilt), dtype=np.float32)
    for i in range(nfilt):
        freqs = []
        for j in range(3):
            step = (i + j * 2) if doublewide else (i + j)
            f = _melinv(np.float32(np.float32(step) * melbw + melmin),
                        unwarp)
            if round_filters:
                f = np.float32(int(f / fftfreq + 0.5) * fftfreq)
            freqs.append(np.float32(f))
        for k in range(n_bins):
            hz = np.float32(np.float32(k) * fftfreq)
            if hz < freqs[0]:
                continue
            if hz > freqs[2] or k == nfft // 2:
                break
            lo = np.float32((hz - freqs[0]) / (freqs[1] - freqs[0]))
            hi = np.float32((freqs[2] - hz) / (freqs[2] - freqs[1]))
            if unit_area:
                lo = np.float32(lo * np.float32(2.0 / (freqs[2] - freqs[0])))
                hi = np.float32(hi * np.float32(2.0 / (freqs[2] - freqs[0])))
            fb[k, i] = min(lo, hi)
    return fb


def build_dct(nfilt: int, ncep: int, transform: str = "legacy") -> np.ndarray:
    """DCT matrix [nfilt, ncep] float64 built from float32 cosines, matching
    fe_compute_melcosine + fe_dct2/fe_spec2cep."""
    cos = np.zeros((ncep, nfilt), dtype=np.float32)
    freqstep = math.pi / nfilt
    for i in range(ncep):
        for j in range(nfilt):
            cos[i, j] = np.float32(math.cos(freqstep * i * (j + 0.5)))
    m = cos.T.astype(np.float64)  # [nfilt, ncep]
    if transform == "dct":
        m = m * math.sqrt(2.0 / nfilt)
        m[:, 0] = np.float32(math.sqrt(1.0 / nfilt))
    elif transform == "htk":
        m = m * math.sqrt(2.0 / nfilt)
        m[:, 0] = np.float32(math.sqrt(2.0 / nfilt))
    elif transform == "legacy":
        m = m / nfilt
        m[0, :] *= 0.5
        m[:, 0] = 1.0 / nfilt
        m[0, 0] = 0.5 / nfilt
    else:
        raise ValueError(f"unknown transform {transform!r}")
    return m


def build_lifter(ncep: int, lifter_val: int) -> np.ndarray | None:
    if not lifter_val:
        return None
    i = np.arange(ncep)
    return (1.0 + lifter_val / 2.0 * np.sin(i * math.pi / lifter_val)
            ).astype(np.float32)


@dataclass
class MelFrontend:
    """Frontend configuration + precomputed tables.

    Parameter names and defaults mirror the reference config
    (src/fe/fe.h:68-219): samprate, frate, wlen, alpha, ncep, nfft, nfilt,
    lowerf, upperf, transform, lifter, remove_dc, remove_noise, dither.
    """

    samprate: int = 16000
    frate: int = 100
    wlen: float = 0.025625
    alpha: float = 0.97
    ncep: int = 13
    nfft: int = 0
    nfilt: int = 40
    lowerf: float = 133.33334
    upperf: float = 6855.4976
    transform: str = "legacy"
    lifter_val: int = 0
    doublewide: bool = False
    warp_type: str | None = None
    warp_params: str | None = None
    remove_dc: bool = False
    remove_noise: bool = True
    round_filters: bool = True
    unit_area: bool = True
    logspec: bool = False

    def __post_init__(self):
        self.frame_shift = self.samprate // self.frate
        self.frame_size = int(self.wlen * self.samprate)
        if not self.nfft:
            n = 1
            while n < self.frame_size:
                n <<= 1
            self.nfft = n
        # Symmetric Hamming window (float64, fe_create_hamming)
        i = np.arange(self.frame_size // 2)
        half = 0.54 - 0.46 * np.cos(2 * math.pi * i / (self.frame_size - 1.0))
        self.window = np.concatenate([half, half[::-1]]) if self.frame_size % 2 == 0 \
            else np.concatenate([half, [1.0], half[::-1]])
        self.mel_fb = build_mel_filterbank(
            self.samprate, self.nfft, self.nfilt, self.lowerf, self.upperf,
            self.doublewide, self.round_filters, self.unit_area,
            self.warp_type, self.warp_params)
        self.dct = build_dct(self.nfilt, self.ncep, self.transform)
        self.lifter = build_lifter(self.ncep, self.lifter_val)

    # ------------------------------------------------------------------
    # Frame counts
    # ------------------------------------------------------------------

    @classmethod
    def from_config(cls, config) -> "MelFrontend":
        """Build from a Config object (config.py parameter namespace)."""
        return cls(
            samprate=int(config["samprate"]), frate=int(config["frate"]),
            wlen=float(config["wlen"]), alpha=float(config["alpha"]),
            ncep=int(config["ncep"]), nfft=int(config["nfft"]),
            nfilt=int(config["nfilt"]), lowerf=float(config["lowerf"]),
            upperf=float(config["upperf"]),
            transform=str(config["transform"]),
            lifter_val=int(config["lifter"]),
            doublewide=bool(config["doublebw"]),
            remove_dc=bool(config["remove_dc"]),
            remove_noise=bool(config["remove_noise"]),
            round_filters=bool(config["round_filters"]),
            unit_area=bool(config["unit_area"]),
            logspec=bool(config["logspec"]),
            warp_type=config["warp_type"],
            warp_params=config["warp_params"],
        )

    def n_full_frames(self, nsamps: int) -> int:
        """Frames produced by fe_process_frames (no end-of-utt flush)."""
        if nsamps < self.frame_size:
            return 0
        return 1 + (nsamps - self.frame_size) // self.frame_shift

    def n_frames(self, nsamps: int) -> int:
        """Total frames for a whole utterance *including* the final short
        frame flushed by fe_end_utt (src/fe/fe_interface.c:529-545): the
        leftover samples from position n_full*shift, zero-padded."""
        if nsamps <= 0:
            return 0
        if nsamps < self.frame_size:
            return 1
        return self.n_full_frames(nsamps) + 1

    # ------------------------------------------------------------------
    # Host path (float64, matches the reference float build)
    # ------------------------------------------------------------------

    def mel_spectrum(self, pcm: np.ndarray) -> np.ndarray:
        """PCM int16 [N] -> mel power spectrum [T, nfilt] float64
        (pre-noise-removal), including the fe_end_utt tail frame."""
        x = np.asarray(pcm, dtype=np.float64)
        n = len(x)
        T = self.n_frames(n)
        if T <= 0:
            return np.zeros((0, self.nfilt))
        y = x - self.alpha * np.concatenate([[0.0], x[:-1]])
        # zero-pad so the tail frame window (starting at n_full*shift)
        # reads zeros past the end, like the reference's frame padding
        y = np.concatenate([y, np.zeros(self.frame_size)])
        idx = (np.arange(T)[:, None] * self.frame_shift
               + np.arange(self.frame_size)[None, :])
        frames = y[idx]
        if self.remove_dc:
            frames = frames - frames.mean(axis=1, keepdims=True)
        frames = frames * self.window[None, :]
        spec = np.fft.rfft(frames, n=self.nfft, axis=1)
        power = spec.real ** 2 + spec.imag ** 2
        return power @ self.mel_fb.astype(np.float64)

    def process(self, pcm: np.ndarray) -> np.ndarray:
        """PCM int16 [N] -> MFCC [T, ncep] float32 (one whole utterance,
        on the host)."""
        mfspec = self.mel_spectrum(pcm)
        if self.remove_noise:
            mfspec = noise_removal_np(mfspec)
        logspec = np.log(mfspec + LOG_FLOOR)
        if self.logspec:
            return logspec.astype(np.float32)
        cep = logspec @ self.dct
        if self.lifter is not None:
            cep = cep * self.lifter[None, :]
        return cep.astype(np.float32)

    # ------------------------------------------------------------------
    # Batched device path
    # ------------------------------------------------------------------

    def process_batch(self, pcm, n_samps=None, device=None):
        """[B, N] PCM (padded; a tensor, or an array moved to `device`,
        CUDA by default) -> ([B, T, ncep] float32 MFCC, [B] int32 frame
        counts).  Port of `process_batch_jax`."""
        if not torch.is_tensor(pcm):
            pcm = torch.as_tensor(np.asarray(pcm, np.float32),
                                  device=resolve_device(device))
        pcm = pcm.to(torch.float32)
        dev = pcm.device
        B, N = pcm.shape
        T = self.n_frames(N)
        if n_samps is None:
            n_samps = torch.full((B,), N, dtype=torch.int32, device=dev)
        n_samps = torch.as_tensor(n_samps, device=dev).to(torch.int32)
        n_full = torch.where(
            n_samps < self.frame_size, 0,
            1 + torch.div(n_samps - self.frame_size, self.frame_shift,
                          rounding_mode="floor"))
        n_frames = torch.where(
            n_samps <= 0, 0,
            torch.where(n_samps < self.frame_size, 1, n_full + 1)
        ).to(torch.int32)
        # zero samples at/after each utterance's length so its tail frame
        # reads zeros (fe_end_utt zero-padding), then pre-emphasize
        valid = torch.arange(N, device=dev)[None, :] < n_samps[:, None]
        shifted = torch.nn.functional.pad(pcm[:, :-1], (1, 0))
        y = pcm - self.alpha * shifted
        y = torch.where(valid, y, torch.zeros_like(y))
        y = torch.nn.functional.pad(y, (0, self.frame_size))
        idx = (torch.arange(T, device=dev)[:, None] * self.frame_shift
               + torch.arange(self.frame_size, device=dev)[None, :])
        frames = y[:, idx]                            # [B, T, frame_size]
        if self.remove_dc:
            frames = frames - frames.mean(dim=-1, keepdim=True)
        frames = frames * torch.as_tensor(self.window, dtype=torch.float32,
                                          device=dev)
        spec = torch.fft.rfft(frames, n=self.nfft, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        mfspec = power @ torch.as_tensor(self.mel_fb, device=dev)
        if self.remove_noise:
            mfspec = noise_removal(mfspec)
        logspec = torch.log(mfspec + LOG_FLOOR)
        cep = logspec @ torch.as_tensor(self.dct, dtype=torch.float32,
                                        device=dev)
        if self.lifter is not None:
            cep = cep * torch.as_tensor(self.lifter, device=dev)[None, None]
        return cep, n_frames


# ---------------------------------------------------------------------------
# Noise removal (fe_noise.c): sequential minima-tracking over frames
# ---------------------------------------------------------------------------

def _lower_env(buf, floor_buf):
    """fe_lower_envelope: asymmetric exponential floor tracker."""
    return np.where(buf >= floor_buf,
                    LAMBDA_A * floor_buf + (1 - LAMBDA_A) * buf,
                    LAMBDA_B * floor_buf + (1 - LAMBDA_B) * buf)


def _smooth_gain(mfspec, gain):
    """fe_weight_smooth: boxcar-average the gains over +/-SMOOTH_WINDOW
    neighboring filters, multiply into the spectrum."""
    n = gain.shape[-1]
    idx = np.arange(n)
    l1 = np.maximum(idx - SMOOTH_WINDOW, 0)
    l2 = np.minimum(idx + SMOOTH_WINDOW, n - 1)
    cs = np.concatenate([np.zeros(gain.shape[:-1] + (1,)),
                         np.cumsum(gain, axis=-1)], axis=-1)
    avg = (cs[..., l2 + 1] - cs[..., l1]) / (l2 - l1 + 1)
    return mfspec * avg


def noise_removal_np(mfspec: np.ndarray) -> np.ndarray:
    """[T, nfilt] float64 -> denoised, sequential host implementation."""
    T, n = mfspec.shape
    if T == 0:
        return mfspec
    power = mfspec[0].copy()
    noise = mfspec[0] / MAX_GAIN
    floor = mfspec[0] / MAX_GAIN
    peak = np.zeros(n)
    out = np.empty_like(mfspec)
    for t in range(T):
        x = mfspec[t]
        power = LAMBDA_POWER * power + (1 - LAMBDA_POWER) * x
        noise = _lower_env(power, noise)
        signal = np.maximum(power - noise, 1.0)
        floor = _lower_env(signal, floor)
        # temporal masking (fe_temp_masking): peak decays, signal floored
        # at peak*MU_T, then peak raised to the *current* signal value
        cur_in = signal.copy()
        peak = peak * LAMBDA_T
        signal = np.where(signal < LAMBDA_T * peak, peak * MU_T, signal)
        peak = np.where(cur_in > peak, cur_in, peak)
        signal = np.maximum(signal, floor)
        # guard power == 0 (silence): the reference takes the MAX_GAIN
        # branch since signal >= 1.0 > MAX_GAIN*0; avoid evaluating x/0
        gain = np.where(signal < MAX_GAIN * power,
                        np.divide(signal, power,
                                  out=np.full_like(signal, MAX_GAIN),
                                  where=power > 0),
                        MAX_GAIN)
        gain = np.maximum(gain, 1.0 / MAX_GAIN)
        out[t] = _smooth_gain(x, gain)
    return out


def noise_removal(mfspec):
    """[B, T, nfilt] -> denoised, a loop over T.  Port of
    `noise_removal_jax`: frames beyond an utterance's length still flow
    through the recurrence (their values are garbage but do not affect
    earlier frames; downstream masking applies)."""
    B, T, n = mfspec.shape
    power = mfspec[:, 0]
    noise = mfspec[:, 0] / MAX_GAIN
    floor = mfspec[:, 0] / MAX_GAIN
    peak = torch.zeros_like(power)
    gains = torch.empty_like(mfspec)
    for t in range(T):
        x = mfspec[:, t]
        power = LAMBDA_POWER * power + (1 - LAMBDA_POWER) * x
        noise = torch.where(power >= noise,
                            LAMBDA_A * noise + (1 - LAMBDA_A) * power,
                            LAMBDA_B * noise + (1 - LAMBDA_B) * power)
        signal = torch.clamp(power - noise, min=1.0)
        floor = torch.where(signal >= floor,
                            LAMBDA_A * floor + (1 - LAMBDA_A) * signal,
                            LAMBDA_B * floor + (1 - LAMBDA_B) * signal)
        cur_in = signal
        peak = peak * LAMBDA_T
        signal = torch.where(signal < LAMBDA_T * peak, peak * MU_T, signal)
        peak = torch.where(cur_in > peak, cur_in, peak)
        signal = torch.maximum(signal, floor)
        safe_power = torch.clamp(power, min=1e-30)
        gain = torch.where(signal < MAX_GAIN * power, signal / safe_power,
                           torch.full_like(signal, MAX_GAIN))
        gains[:, t] = torch.clamp(gain, min=1.0 / MAX_GAIN)
    # boxcar smooth over the filter axis
    idx = np.arange(n)
    l1 = torch.as_tensor(np.maximum(idx - SMOOTH_WINDOW, 0),
                         device=mfspec.device)
    l2 = torch.as_tensor(np.minimum(idx + SMOOTH_WINDOW, n - 1),
                         device=mfspec.device)
    cs = torch.cat([torch.zeros(gains.shape[:-1] + (1,), dtype=gains.dtype,
                                device=gains.device),
                    torch.cumsum(gains, dim=-1)], dim=-1)
    avg = (cs[..., l2 + 1] - cs[..., l1]) / (l2 - l1 + 1).to(gains.dtype)
    return mfspec * avg
