"""Word-final right-context fan step: CUDA kernel + plain torch version.

Port of `pocketsphinx_tpu.ops.pallas_fan` (the Pallas `_kernel` reached
through `fan_step`).  One step of the fused n-gram scan's finals block,
batched over B utterances:

  * expand the per-final-diphone senone costs `pre [B, 3, NRC, LP]` to
    words by `lp[w]`;
  * run the 3-state Viterbi update with TF/CX token metadata under the
    `ops.hmm.hmm_step_sm` tie rules;
  * merge the chain-last entry `pred/ptf/pcx [B, Wm]` into state 0 on a
    strict '>';
  * write the exit plane `out_f [B, NRC, Wm]` and return the per-word
    exit `esc/etf/ecx [B, Wm]` (the first maximal rc and its payload)
    and partial maxima of the new S, whose max is the scan's
    renormalization term.

The fan carry is padded, as the JAX scan keeps it padded for its Pallas
kernel (`fan_step(..., n_real=...)`): S/TF/CX [B, 3, NRC, Wp] hold
Wp = `padded_width(Wm)` columns, so that every plane row is 16-byte
aligned for the kernel, and `lp` [Wp] and `tp` [12, Wp] are padded
alike (the decoder pads them once, in its device tables).  Only the Wm
real words are computed: the new carry's pads are NEG_INF scores and 0
payloads, and no pad reaches the exits, the exit plane or the maxima.

`fan_step` launches `csrc/fan.cu` for CUDA tensors and runs
`fan_step_ref` only for CPU tensors.  `lp` and `tp` are shared by the
batch and must be unbatched.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .hmm import NEG_INF

#: launches of the CUDA kernel since the last reset (plain int); a
#: replay of the scan's CUDA graph adds the launches its capture made,
#: which counted in the capturing thread's `_build.tally` instead
#: (`search.ngram_fused._ScanGraph`)
launches = 0

#: the fan carry's width is a multiple of PAD columns (16 bytes)
PAD = 4
#: the kernel's choices of plane groups per block (`fan_step(groups=)`)
GROUPS = (1, 2, 4)
#: threads per block of the kernel (TPB in csrc/fan.cu); at its
#: registers a streaming multiprocessor holds one block
_TPB = 256
#: the most dynamic shared memory a block may take on an H100
_SMEM_BYTES = 232448 - 4 * _TPB // 32


def reset_launches():
    global launches
    launches = 0


def padded_width(w: int) -> int:
    """The fan carry's width for `w` multi-phone words."""
    return -(-w // PAD) * PAD


def fan_step_ref(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f=None):
    """Plain torch version of the fan step (see module docstring).

    S/TF/CX [B, 3, NRC, Wp] f32/i32/i32; pred/ptf/pcx [B, Wm];
    pre [B, 3, NRC, LP] f32; lp [Wp] int; tp [12, Wp] f32 rows j*4+k;
    out_f: None, or a [B, NRC, Wm] float32 view to write the exit plane
    into (any strides).
    Returns (newS, newTF, newCX [B, 3, NRC, Wp], out_f [B, NRC, Wm],
             esc, etf, ecx [B, Wm], mx [B, 1]): mx's max over its
    columns is the max of newS over the real words."""
    Wm = pred.shape[-1]
    Wp = S.shape[-1]
    S, TF, CX = S[..., :Wm], TF[..., :Wm], CX[..., :Wm]
    sen = -pre[..., lp[:Wm].long()]                  # [B, 3, NRC, Wm]
    s0, s1, s2 = (S[:, j] + sen[:, j] for j in range(3))
    m0tf, m1tf, m2tf = TF[:, 0], TF[:, 1], TF[:, 2]
    m0cx, m1cx, m2cx = CX[:, 0], CX[:, 1], CX[:, 2]
    T = lambda r: tp[r, :Wm][None, None, :]          # noqa: E731

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
    if out_f is None:
        out_f = out
    else:
        out_f.copy_(out)
    shape = S.shape[:3] + (Wp,)
    nS = torch.full(shape, NEG_INF, dtype=torch.float32, device=S.device)
    nTF = torch.zeros(shape, dtype=torch.int32, device=S.device)
    nCX = torch.zeros(shape, dtype=torch.int32, device=S.device)
    for j, (s, f, c) in enumerate(((n0, n0tf, n0cx), (n1, n1tf, n1cx),
                                   (n2, n2tf, n2cx))):
        nS[:, j, :, :Wm] = s
        nTF[:, j, :, :Wm] = f
        nCX[:, j, :, :Wm] = c
    mx = nS[..., :Wm].amax(dim=(1, 2, 3))[:, None]
    return nS, nTF, nCX, out_f, esc, etf, ecx, mx


def _check(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f):
    if S.dim() != 4 or S.shape[1] != 3 or S.shape[2] < 1:
        raise ValueError(f"S must be [B, 3, NRC, Wp], got {tuple(S.shape)}")
    if pred.dim() != 2:
        raise ValueError(f"pred must be [B, Wm], got {tuple(pred.shape)}")
    B, _, NRC, Wp = S.shape
    Wm = pred.shape[1]
    if Wp != padded_width(Wm):
        raise ValueError(f"S: width {Wp} != padded_width({Wm}) = "
                         f"{padded_width(Wm)}")
    want = {"S": (S, torch.float32, (B, 3, NRC, Wp)),
            "TF": (TF, torch.int32, (B, 3, NRC, Wp)),
            "CX": (CX, torch.int32, (B, 3, NRC, Wp)),
            "pred": (pred, torch.float32, (B, Wm)),
            "ptf": (ptf, torch.int32, (B, Wm)),
            "pcx": (pcx, torch.int32, (B, Wm)),
            "lp": (lp, torch.int32, (Wp,)),
            "tp": (tp, torch.float32, (12, Wp))}
    if pre.dim() != 4 or tuple(pre.shape[:3]) != (B, 3, NRC):
        raise ValueError(f"pre must be [B, 3, NRC, LP], got "
                         f"{tuple(pre.shape)}")
    want["pre"] = (pre, torch.float32, tuple(pre.shape))
    if out_f is not None:
        want["out_f"] = (out_f, torch.float32, (B, NRC, Wm))
    for name, (x, dt, shape) in want.items():
        if tuple(x.shape) != shape:
            # lp/tp are shared by the batch: a batched lp/tp is refused
            # rather than silently read as the first element's
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")
        if x.dtype != dt:
            raise TypeError(f"{name}: dtype {x.dtype} != {dt}")
        if x.device != S.device:
            raise ValueError(f"{name}: device {x.device} != {S.device}")
        if name == "out_f":
            if Wm > 1 and x.stride(2) != 1:
                raise ValueError("out_f: its rows must be contiguous")
        elif not x.is_contiguous():
            raise ValueError(f"{name}: not contiguous")


def _groups(B, Wp, LP, n_sm):
    """The fewest plane groups whose grid has twice the threads that
    `n_sm` multiprocessors hold at once (one block each), else the most,
    within the shared memory a block may take."""
    fits = [g for g in GROUPS if 2 * g * 3 * LP * 4 <= _SMEM_BYTES]
    if not fits:
        raise ValueError(f"fan_step: LP = {LP} diphone costs do not fit in "
                         f"shared memory")
    for g in fits:
        if B * (Wp // PAD) * g >= 2 * n_sm * _TPB:
            return g
    return fits[-1]


def fan_step(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f=None,
             groups=None):
    """Fan step on the tensors' device: the CUDA kernel for CUDA
    tensors, `fan_step_ref` for CPU tensors.  Same arguments and results
    as `fan_step_ref`, except that on CUDA mx holds one partial maximum
    per block of the kernel, and `groups` (one of `GROUPS`; default:
    chosen from the shapes) sets the kernel's plane groups per block."""
    global launches
    _check(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f)
    if groups is not None and groups not in GROUPS:
        raise ValueError(f"fan_step: groups {groups} not in {GROUPS}")
    if S.device.type == "cpu":
        return fan_step_ref(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f)
    if S.device.type != "cuda":
        raise ValueError(f"fan_step: unsupported device {S.device}")
    B, _, NRC, Wp = S.shape
    Wm = pred.shape[1]
    LP = pre.shape[-1]
    if groups is None:
        groups = _groups(B, Wp, LP, torch.cuda.get_device_properties(
            S.device).multi_processor_count)
    for name, x in (("S", S), ("TF", TF), ("CX", CX), ("lp", lp),
                    ("tp", tp)):
        if x.data_ptr() % 16:
            raise ValueError(f"fan_step: {name} is not 16-byte aligned")
    lib = _lib()
    dev = S.device
    nS = torch.empty_like(S)
    nTF = torch.empty_like(TF)
    nCX = torch.empty_like(CX)
    if out_f is None:
        out_f = torch.empty((B, NRC, Wm), dtype=torch.float32, device=dev)
    esc = torch.empty((B, Wm), dtype=torch.float32, device=dev)
    etf = torch.empty((B, Wm), dtype=torch.int32, device=dev)
    ecx = torch.empty((B, Wm), dtype=torch.int32, device=dev)
    mx = torch.empty((B, -(-Wp // (PAD * _TPB // groups))),
                     dtype=torch.float32, device=dev)
    if B and Wm:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fan_step_launch(
                *(x.data_ptr() for x in (S, TF, CX, pred, ptf, pcx, pre, lp,
                                         tp, nS, nTF, nCX, out_f, esc, etf,
                                         ecx, mx)),
                out_f.stride(0), out_f.stride(1), B, NRC, Wm, Wp, LP,
                groups, stream)
        if err:
            raise RuntimeError("fan_step_launch: "
                               + lib.fan_error_string(err).decode())
        if not _build.tallied("fan"):
            launches += 1
    return nS, nTF, nCX, out_f, esc, etf, ecx, mx


def _lib():
    lib = _build.load("fan")
    if not getattr(lib, "_typed", False):
        lib.fan_step_launch.argtypes = (
            [ctypes.c_void_p] * 17 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.fan_step_launch.restype = ctypes.c_int
        lib.fan_error_string.argtypes = [ctypes.c_int]
        lib.fan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
