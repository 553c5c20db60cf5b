"""Word-final right-context fan step: CUDA kernel + plain torch version.

Port of `pocketsphinx_tpu.ops.pallas_fan` (the Pallas `_kernel` reached
through `fan_step`).  One step of the fused n-gram scan's finals block,
batched over B utterances:

  * expand the per-final-diphone senone costs `pre [B, 3, NRC, LP]` to
    words by `lp[w]`;
  * run the 3-state Viterbi update with TF/CX token metadata under the
    `ops.hmm.hmm_step_sm` tie rules;
  * merge the chain-last entry `pred/ptf/pcx [B, W]` into state 0 on a
    strict '>';
  * return the exit plane `out_f [B, NRC, W]` and the per-word exit
    `esc/etf/ecx [B, W]`: the first maximal rc and its payload.

`fan_step` launches `csrc/fan.cu` for CUDA tensors and runs
`fan_step_ref` only for CPU tensors.  `lp` and `tp` are shared by the
batch and must be unbatched.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel since the last reset (plain int)
launches = 0


def reset_launches():
    global launches
    launches = 0


def fan_step_ref(S, TF, CX, pred, ptf, pcx, pre, lp, tp):
    """Plain torch version of the fan step (see module docstring).

    S/TF/CX [B, 3, NRC, W] f32/i32/i32; pred/ptf/pcx [B, W];
    pre [B, 3, NRC, LP] f32; lp [W] int; tp [12, W] f32 rows j*4+k.
    Returns (newS, newTF, newCX [B, 3, NRC, W], out_f [B, NRC, W],
             esc, etf, ecx [B, W])."""
    sen = -pre[..., lp.long()]                       # [B, 3, NRC, W]
    s0, s1, s2 = (S[:, j] + sen[:, j] for j in range(3))
    m0tf, m1tf, m2tf = TF[:, 0], TF[:, 1], TF[:, 2]
    m0cx, m1cx, m2cx = CX[:, 0], CX[:, 1], CX[:, 2]
    T = lambda r: tp[r][None, None, :]               # noqa: E731

    lo = s1 + T(7)
    hi = s2 + T(11)
    hi_wins = hi > lo
    out = torch.where(hi_wins, hi, lo)
    otf = torch.where(hi_wins, m2tf, m1tf)
    ocx = torch.where(hi_wins, m2cx, m1cx)

    prev2, self2, skip2 = s1 + T(6), s2 + T(10), s0 + T(2)
    best2 = torch.maximum(prev2, self2)
    take_self2 = self2 > prev2
    take_skip2 = skip2 > best2
    n2 = torch.where(take_skip2, skip2, best2)
    n2tf = torch.where(take_skip2, m0tf, torch.where(take_self2, m2tf, m1tf))
    n2cx = torch.where(take_skip2, m0cx, torch.where(take_self2, m2cx, m1cx))

    prev1, self1 = s0 + T(1), s1 + T(5)
    n1 = torch.maximum(prev1, self1)
    take_self1 = self1 > prev1
    n1tf = torch.where(take_self1, m1tf, m0tf)
    n1cx = torch.where(take_self1, m1cx, m0cx)

    n0 = s0 + T(0)
    win = pred[:, None, :] > n0
    n0 = torch.where(win, pred[:, None, :], n0)
    n0tf = torch.where(win, ptf[:, None, :], m0tf)
    n0cx = torch.where(win, pcx[:, None, :], m0cx)

    esc, am = torch.max(out, dim=1)                  # first maximal rc
    etf = torch.gather(otf, 1, am[:, None]).squeeze(1)
    ecx = torch.gather(ocx, 1, am[:, None]).squeeze(1)
    return (torch.stack([n0, n1, n2], 1), torch.stack([n0tf, n1tf, n2tf], 1),
            torch.stack([n0cx, n1cx, n2cx], 1), out, esc, etf, ecx)


def _check(S, TF, CX, pred, ptf, pcx, pre, lp, tp):
    if S.dim() != 4 or S.shape[1] != 3:
        raise ValueError(f"S must be [B, 3, NRC, W], got {tuple(S.shape)}")
    B, _, NRC, W = S.shape
    want = {"S": (S, torch.float32, (B, 3, NRC, W)),
            "TF": (TF, torch.int32, (B, 3, NRC, W)),
            "CX": (CX, torch.int32, (B, 3, NRC, W)),
            "pred": (pred, torch.float32, (B, W)),
            "ptf": (ptf, torch.int32, (B, W)),
            "pcx": (pcx, torch.int32, (B, W)),
            "lp": (lp, torch.int32, (W,)),
            "tp": (tp, torch.float32, (12, W))}
    if pre.dim() != 4 or tuple(pre.shape[:3]) != (B, 3, NRC):
        raise ValueError(f"pre must be [B, 3, NRC, LP], got "
                         f"{tuple(pre.shape)}")
    want["pre"] = (pre, torch.float32, tuple(pre.shape))
    for name, (x, dt, shape) in want.items():
        if tuple(x.shape) != shape:
            # lp/tp are shared by the batch: a batched lp/tp is refused
            # rather than silently read as the first element's
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")
        if x.dtype != dt:
            raise TypeError(f"{name}: dtype {x.dtype} != {dt}")
        if x.device != S.device:
            raise ValueError(f"{name}: device {x.device} != {S.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: not contiguous")


def fan_step(S, TF, CX, pred, ptf, pcx, pre, lp, tp):
    """Fan step on the tensors' device: the CUDA kernel for CUDA
    tensors, `fan_step_ref` for CPU tensors.  Same arguments and
    results as `fan_step_ref`."""
    global launches
    _check(S, TF, CX, pred, ptf, pcx, pre, lp, tp)
    if S.device.type == "cpu":
        return fan_step_ref(S, TF, CX, pred, ptf, pcx, pre, lp, tp)
    if S.device.type != "cuda":
        raise ValueError(f"fan_step: unsupported device {S.device}")
    lib = _lib()
    B, _, NRC, W = S.shape
    nS = torch.empty_like(S)
    nTF = torch.empty_like(TF)
    nCX = torch.empty_like(CX)
    outf = torch.empty((B, NRC, W), dtype=torch.float32, device=S.device)
    esc = torch.empty((B, W), dtype=torch.float32, device=S.device)
    etf = torch.empty((B, W), dtype=torch.int32, device=S.device)
    ecx = torch.empty((B, W), dtype=torch.int32, device=S.device)
    if B and W:
        with torch.cuda.device(S.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fan_step_launch(
                *(x.data_ptr() for x in (S, TF, CX, pred, ptf, pcx, pre, lp,
                                         tp, nS, nTF, nCX, outf, esc, etf,
                                         ecx)),
                B, NRC, W, pre.shape[-1], stream)
        if err:
            raise RuntimeError("fan_step_launch: "
                               + lib.fan_error_string(err).decode())
        launches += 1
    return nS, nTF, nCX, outf, esc, etf, ecx


def _lib():
    lib = _build.load("fan")
    if not getattr(lib, "_typed", False):
        lib.fan_step_launch.argtypes = [ctypes.c_void_p] * 16 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.fan_step_launch.restype = ctypes.c_int
        lib.fan_error_string.argtypes = [ctypes.c_int]
        lib.fan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
