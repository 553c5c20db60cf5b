"""Word-final right-context fan step: CUDA kernel + plain torch version.

Port of `pocketsphinx_tpu.ops.pallas_fan` (the Pallas `_kernel` reached
through `fan_step`) and of the JAX scan's XLA finals block, which the
JAX package runs for 5-state models.  One step of the fused n-gram
scan's finals block for HMMs of NST emitting states (the kernel is built
for `NSTS`: 3 and 5; the plain version takes any), batched over B
utterances:

  * subtract `m_prev [B]`, the previous frame's renormalization that the
    scan defers to this load, from every score of the carry it reads
    (optional; none by default);
  * expand the per-final-diphone senone costs `pre [B, NST, NRC, LP]`
    to words by `lp[w]`;
  * run the NST-state Viterbi update with TF/CX token metadata under the
    `ops.hmm.hmm_step_sm` tie rules;
  * merge the chain-last entry `pred/ptf/pcx [B, Wm]` into state 0 on a
    strict '>';
  * write the exit plane `out_f [B, NRC, Wm]` and return the per-word
    exit `esc/etf/ecx [B, Wm]` (the first maximal rc and its payload)
    and partial maxima of the new S, whose max is the scan's
    renormalization term.

The fan carry is padded, as the JAX scan keeps it padded for its Pallas
kernel (`fan_step(..., n_real=...)`): S/TF/CX [B, NST, NRC, Wp] hold
Wp = `padded_width(Wm)` columns, so that every plane row is 16-byte
aligned for the kernel, and `lp` [Wp] and `tp` [NST (NST + 1), Wp] (row
j (NST + 1) + k: the transition j -> k) are padded alike (the decoder
pads them once, in its device tables).  Only the Wm real words are
computed: the new carry's pads are NEG_INF scores and 0 payloads, and no
pad reaches the exits, the exit plane or the maxima.

`fan_step` launches `csrc/fan.cu` for CUDA tensors (NST in `NSTS`) and
runs `fan_step_ref` only for CPU tensors.  `lp` and `tp` are shared by the
batch and must be unbatched.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .hmm import NEG_INF, hmm_step_sm

#: the fan carry's width is a multiple of PAD columns (16 bytes)
PAD = 4
#: the HMM topologies (emitting states) the kernel is built for
NSTS = (3, 5)
#: the kernel's choices of plane groups per block (`fan_step(groups=)`)
GROUPS = (1, 2, 4)
#: threads per block of the kernel (TPB in csrc/fan.cu); at its
#: registers a streaming multiprocessor holds one block
_TPB = 256
#: the most dynamic shared memory a block may take on an H100
_SMEM_BYTES = 232448 - 4 * _TPB // 32


def padded_width(w: int) -> int:
    """The fan carry's width for `w` multi-phone words."""
    return -(-w // PAD) * PAD


def fan_step_ref(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f=None,
                 m_prev=None):
    """Plain torch version of the fan step (see module docstring).

    S/TF/CX [B, NST, NRC, Wp] f32/i32/i32; pred/ptf/pcx [B, Wm];
    pre [B, NST, NRC, LP] f32; lp [Wp] int; tp [NST (NST + 1), Wp] f32
    rows j (NST + 1) + k; out_f: None, or a [B, NRC, Wm] float32 view to
    write the exit plane into (any strides); m_prev: None, or [B] f32
    offsets subtracted from S before the step (S - m_prev, then the step
    without it).
    Returns (newS, newTF, newCX [B, NST, NRC, Wp], out_f [B, NRC, Wm],
             esc, etf, ecx [B, Wm], mx [B, 1]): mx's max over its
    columns is the max of newS over the real words."""
    B, NST, NRC, Wp = S.shape
    Wm = pred.shape[-1]
    if m_prev is not None:
        S = S - m_prev[:, None, None, None]
    S, TF, CX = S[..., :Wm], TF[..., :Wm], CX[..., :Wm]
    sen = -pre[..., lp[:Wm].long()]                  # [B, NST, NRC, Wm]
    tpw = tp[:, :Wm].T.reshape(Wm, NST, NST + 1)     # [Wm, j, k]: j -> k
    ns, (nf, nc), out, _, (otf, ocx) = hmm_step_sm(
        tuple(S.unbind(1)), tuple(sen.unbind(1)), tpw,
        metas=(tuple(TF.unbind(1)), tuple(CX.unbind(1))))
    # state 0: the chain-last entry on a strict '>'
    win = pred[:, None, :] > ns[0]
    n0 = (torch.where(win, pred[:, None, :], ns[0]),
          torch.where(win, ptf[:, None, :], nf[0]),
          torch.where(win, pcx[:, None, :], nc[0]))

    esc, am = torch.max(out, dim=1)                  # first maximal rc
    etf = torch.gather(otf, 1, am[:, None]).squeeze(1)
    ecx = torch.gather(ocx, 1, am[:, None]).squeeze(1)
    if out_f is None:
        out_f = out
    else:
        out_f.copy_(out)
    shape = (B, NST, NRC, Wp)
    nS = torch.full(shape, NEG_INF, dtype=torch.float32, device=S.device)
    nTF = torch.zeros(shape, dtype=torch.int32, device=S.device)
    nCX = torch.zeros(shape, dtype=torch.int32, device=S.device)
    states = [n0] + list(zip(ns[1:], nf[1:], nc[1:]))
    for j, (s, f, c) in enumerate(states):
        nS[:, j, :, :Wm] = s
        nTF[:, j, :, :Wm] = f
        nCX[:, j, :, :Wm] = c
    mx = nS[..., :Wm].amax(dim=(1, 2, 3))[:, None]
    return nS, nTF, nCX, out_f, esc, etf, ecx, mx


def _check(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f, m_prev):
    if S.dim() != 4 or S.shape[1] < 2 or S.shape[2] < 1:
        raise ValueError(f"S must be [B, NST, NRC, Wp], got "
                         f"{tuple(S.shape)}")
    if S.is_cuda and S.shape[1] not in NSTS:
        raise ValueError(f"fan_step: the kernel takes NST in {NSTS}, got "
                         f"{S.shape[1]}")
    if pred.dim() != 2:
        raise ValueError(f"pred must be [B, Wm], got {tuple(pred.shape)}")
    B, NST, NRC, Wp = S.shape
    Wm = pred.shape[1]
    if Wp != padded_width(Wm):
        raise ValueError(f"S: width {Wp} != padded_width({Wm}) = "
                         f"{padded_width(Wm)}")
    want = {"S": (S, torch.float32, (B, NST, NRC, Wp)),
            "TF": (TF, torch.int32, (B, NST, NRC, Wp)),
            "CX": (CX, torch.int32, (B, NST, NRC, Wp)),
            "pred": (pred, torch.float32, (B, Wm)),
            "ptf": (ptf, torch.int32, (B, Wm)),
            "pcx": (pcx, torch.int32, (B, Wm)),
            "lp": (lp, torch.int32, (Wp,)),
            "tp": (tp, torch.float32, (NST * (NST + 1), Wp))}
    if pre.dim() != 4 or tuple(pre.shape[:3]) != (B, NST, NRC):
        raise ValueError(f"pre must be [B, {NST}, NRC, LP], got "
                         f"{tuple(pre.shape)}")
    want["pre"] = (pre, torch.float32, tuple(pre.shape))
    if out_f is not None:
        want["out_f"] = (out_f, torch.float32, (B, NRC, Wm))
    if m_prev is not None:
        want["m_prev"] = (m_prev, torch.float32, (B,))
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


def _smem_bytes(NST, G, LP):
    """The dynamic shared memory a block of the kernel takes
    (`smem_bytes` in csrc/fan.cu): the double-buffered diphone costs (at
    least the groups' exits), and at 5 states the block's transition
    rows."""
    stage = -(-max(2 * G * NST * LP, 3 * 4 * _TPB) // 4) * 4
    rows = (3 * NST - 1) * 4 * (_TPB // G) if NST > 3 else 0
    return 4 * (stage + rows)


def _groups(B, Wp, LP, n_sm, NST=3):
    """The fewest plane groups whose grid has twice the threads that
    `n_sm` multiprocessors hold at once (one block each), else the most,
    within the shared memory a block may take."""
    fits = [g for g in GROUPS if _smem_bytes(NST, g, LP) <= _SMEM_BYTES]
    if not fits:
        raise ValueError(f"fan_step: LP = {LP} diphone costs of {NST} "
                         f"states do not fit in shared memory")
    for g in fits:
        if B * (Wp // PAD) * g >= 2 * n_sm * _TPB:
            return g
    return fits[-1]


def fan_step(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f=None,
             groups=None, m_prev=None):
    """Fan step on the tensors' device: the CUDA kernel for CUDA
    tensors, `fan_step_ref` for CPU tensors.  Same arguments and results
    as `fan_step_ref` (the kernel subtracts `m_prev` from each score as
    it loads it), except that on CUDA mx holds one partial maximum
    per block of the kernel, and `groups` (one of `GROUPS`; default:
    chosen from the shapes) sets the kernel's plane groups per block."""
    _check(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f, m_prev)
    if groups is not None and groups not in GROUPS:
        raise ValueError(f"fan_step: groups {groups} not in {GROUPS}")
    if S.device.type == "cpu":
        return fan_step_ref(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f,
                            m_prev)
    if S.device.type != "cuda":
        raise ValueError(f"fan_step: unsupported device {S.device}")
    B, NST, NRC, Wp = S.shape
    Wm = pred.shape[1]
    LP = pre.shape[-1]
    if groups is None:
        groups = _groups(B, Wp, LP, torch.cuda.get_device_properties(
            S.device).multi_processor_count, NST)
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
    if m_prev is None:                       # the kernel always reads [B]
        m_prev = torch.zeros(B, dtype=torch.float32, device=dev)
    esc = torch.empty((B, Wm), dtype=torch.float32, device=dev)
    etf = torch.empty((B, Wm), dtype=torch.int32, device=dev)
    ecx = torch.empty((B, Wm), dtype=torch.int32, device=dev)
    mx = torch.empty((B, -(-Wp // (PAD * _TPB // groups))),
                     dtype=torch.float32, device=dev)
    if B and Wm:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fan_step_launch(
                S.data_ptr(), TF.data_ptr(), CX.data_ptr(), m_prev.data_ptr(),
                *(x.data_ptr() for x in (pred, ptf, pcx, pre, lp, tp, nS,
                                         nTF, nCX, out_f, esc, etf, ecx,
                                         mx)),
                out_f.stride(0), out_f.stride(1), B, NRC, Wm, Wp, LP, NST,
                groups, stream)
        if err:
            raise RuntimeError("fan_step_launch: "
                               + lib.fan_error_string(err).decode())
        _build.launched("fan")
    return nS, nTF, nCX, out_f, esc, etf, ecx, mx


def _lib():
    lib = _build.load("fan")
    if not getattr(lib, "_typed", False):
        lib.fan_step_launch.argtypes = (
            [ctypes.c_void_p] * 18 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.fan_step_launch.restype = ctypes.c_int
        lib.fan_error_string.argtypes = [ctypes.c_int]
        lib.fan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
