"""Noise removal's gains recurrence: CUDA kernel + plain torch version.

Port of the scan of `pocketsphinx_tpu.frontend.mfcc.noise_removal_jax`
(fe_noise.c's Doblinger minima tracking).  For every (utterance, filter)
lane of mfspec [B, T, nfilt] float32, walk the T frames carrying the
smoothed power, the noise and signal floors and the temporal-masking
peak, and give each frame's gain [B, T, nfilt].  Frames past an
utterance's length flow through the recurrence too, as in the JAX scan.
The boxcar smoothing of the gains over the filters stays torch ops
(`frontend.mfcc.noise_removal`).

`gains` launches `csrc/denoise.cu` (one thread per lane, one launch per
batch) for CUDA tensors and runs `gains_ref`, a loop over the frames,
only for CPU tensors.  Both apply each constant as the float32 that
torch rounds it to from the Python double, the (1 - lambda) weights
computed in double first (`CONSTS`), and divide exactly (a CUDA tensor
divided by a Python scalar multiplies by its reciprocal instead, so the
plain version divides by a tensor): the kernel is bit-equal to the plain
version on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# Noise-suppression constants (fe_noise.c:65-74)
LAMBDA_POWER = 0.7
LAMBDA_A = 0.995
LAMBDA_B = 0.5
LAMBDA_T = 0.85
MU_T = 0.2
MAX_GAIN = 20.0
#: the gain's division guard (the JAX scan's `safe_power`)
TINY = 1e-30

#: the kernel's constants in the order of `Consts` in csrc/denoise.cu
CONSTS = np.array([LAMBDA_POWER, 1 - LAMBDA_POWER, LAMBDA_A, 1 - LAMBDA_A,
                   LAMBDA_B, 1 - LAMBDA_B, LAMBDA_T, MU_T, MAX_GAIN,
                   1.0 / MAX_GAIN, TINY], np.float32)


def gains_ref(mfspec):
    """Plain torch version: the gains [B, T, nfilt] of mfspec [B, T,
    nfilt] float32, a loop over the frames."""
    B, T, n = mfspec.shape
    gains = torch.empty_like(mfspec)
    if T == 0:
        return gains
    max_gain = torch.full((), MAX_GAIN, dtype=torch.float32,
                          device=mfspec.device)
    power = mfspec[:, 0]
    noise = mfspec[:, 0] / max_gain
    floor = mfspec[:, 0] / max_gain
    peak = torch.zeros_like(power)
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
        safe_power = torch.clamp(power, min=TINY)
        gain = torch.where(signal < MAX_GAIN * power, signal / safe_power,
                           torch.full_like(signal, MAX_GAIN))
        gains[:, t] = torch.clamp(gain, min=1.0 / MAX_GAIN)
    return gains


def _check(mfspec):
    if mfspec.dim() != 3:
        raise ValueError(f"mfspec must be [B, T, nfilt], got "
                         f"{tuple(mfspec.shape)}")
    if mfspec.dtype != torch.float32:
        raise TypeError(f"mfspec: dtype {mfspec.dtype} != torch.float32")


def gains(mfspec):
    """The gains [B, T, nfilt] of mfspec [B, T, nfilt] float32 on its
    device: one launch of the CUDA kernel for a CUDA tensor, `gains_ref`
    for a CPU tensor."""
    _check(mfspec)
    if mfspec.device.type == "cpu":
        return gains_ref(mfspec)
    if mfspec.device.type != "cuda":
        raise ValueError(f"gains: unsupported device {mfspec.device}")
    lib = _lib()
    x = mfspec.contiguous()
    out = torch.empty_like(x)
    B, T, n = x.shape
    if B and T and n:
        consts = CONSTS.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        with torch.cuda.device(x.device):
            err = lib.denoise_launch(
                x.data_ptr(), out.data_ptr(), B, T, n, consts,
                torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError("denoise_launch: "
                               + lib.denoise_error_string(err).decode())
        _build.launched("denoise")
    return out


def _lib():
    lib = _build.load("denoise")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.denoise_launch.argtypes = [p, p, i, i, i,
                                       ctypes.POINTER(ctypes.c_float), p]
        lib.denoise_launch.restype = ctypes.c_int
        lib.denoise_error_string.argtypes = [ctypes.c_int]
        lib.denoise_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
