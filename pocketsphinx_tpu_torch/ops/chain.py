"""Chain-bucket step: CUDA kernel + plain torch version.

Port of `pocketsphinx_tpu.ops.pallas_chain` (the Pallas `_kernel`
reached through `chain_step`), and of the XLA chain block of the JAX
scan (search/ngram_fused.py), which computes the same function.  One
step of a right-aligned chain bucket [NST, D, W], batched over B:

  * per-variant senone select on first-node rows: the word's variant
    costs `prevd[b, j, v, fd_idx[w]]` with v = min(VAR, nv - 1) (the
    gather by `fd_idx` replaces the JAX scan's one-hot expansion of the
    per-first-diphone planes);
  * the NST-state Viterbi update with TF/CTX/VAR metadata
    (`ops.hmm.hmm_step_sm` tie rules);
  * the intra-word shift `out[d-1] + pip` into state 0 of non-first
    nodes (strict '>'), VAR carried per word;
  * the exit row at depth D-1.

Without variants (`VAR is None`) it is the CI/filler chain step.
`chain_step` launches `csrc/chain.cu` for CUDA tensors and runs
`chain_step_ref` only for CPU tensors.  `tp`, `fm`, `nv` and `fd_idx`
are shared by the batch and must be unbatched.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .hmm import NEG_INF, hmm_step_sm

#: launches of the CUDA kernel since the last reset (plain int)
launches = 0


def reset_launches():
    global launches
    launches = 0


def chain_step_ref(S, TF, CTX, VAR, pre, prevd, fd_idx, tp, fm, nv, pip):
    """Plain torch version of the chain step (see module docstring).

    S/TF/CTX [B, NST, D, W] f32/i32/i32; VAR [B, NST, W] i32 or None;
    pre [B, NST, D, W] f32 costs; prevd [B, NST, RF, NFD] f32 variant
    costs or None; fd_idx [W] int; tp [NST*(NST+1), D, W] f32;
    fm [D, W] bool; nv [W] int (None without variants); pip float.
    Returns (newS, newTF, newCTX [B, NST, D, W], newVAR [B, NST, W],
             exit_score, exit_tf, exit_ctx [B, W])."""
    B, NST, D, W = S.shape
    has_var = VAR is not None
    sen = []
    for j in range(NST):
        s = -pre[:, j]
        if has_var:
            v = torch.minimum(VAR[:, j], nv[None, :] - 1).long()  # [B, W]
            vals = -prevd[:, j][:, :, fd_idx.long()]              # [B,RF,W]
            ok = (v >= 0) & (v < vals.shape[1])
            sf = torch.gather(vals, 1, v.clamp(0, vals.shape[1] - 1)[:, None])
            sf = torch.where(ok, sf[:, 0], torch.zeros_like(sf[:, 0]))
            s = torch.where(fm[None], sf[:, None, :], s)
        sen.append(s)
    tp4 = tp.reshape(NST, NST + 1, D, W).permute(2, 3, 0, 1)   # [D,W,N,N+1]
    metas = [tuple(TF[:, j] for j in range(NST)),
             tuple(CTX[:, j] for j in range(NST))]
    if has_var:
        metas.append(tuple(VAR[:, j][:, None, :].expand(B, D, W)
                           for j in range(NST)))
    newS, nm, out, _, om = hmm_step_sm(
        tuple(S[:, j] for j in range(NST)), tuple(sen), tp4, metas=metas)
    nTF, nCTX = nm[0], nm[1]
    oTF, oCTX = om[0], om[1]
    sh = torch.cat([torch.full_like(out[:, :1], NEG_INF), out[:, :-1]],
                   dim=1) + pip
    sh = torch.where(fm[None], torch.full_like(sh, NEG_INF), sh)
    shTF = torch.cat([oTF[:, :1], oTF[:, :-1]], dim=1)
    shCX = torch.cat([oCTX[:, :1], oCTX[:, :-1]], dim=1)
    win = sh > newS[0]
    s0 = torch.where(win, sh, newS[0])
    tf0 = torch.where(win, shTF, nTF[0])
    cx0 = torch.where(win, shCX, nCTX[0])
    if has_var:
        nVAR = torch.stack([torch.where(fm[None], v, 0).sum(dim=1,
                                                            dtype=torch.int32)
                            for v in nm[2]], 1)
    else:
        nVAR = torch.zeros((B, NST, W), dtype=torch.int32, device=S.device)
    return (torch.stack((s0,) + newS[1:], 1),
            torch.stack((tf0,) + nTF[1:], 1),
            torch.stack((cx0,) + nCTX[1:], 1),
            nVAR, out[:, -1], oTF[:, -1], oCTX[:, -1])


def _check(S, TF, CTX, VAR, pre, prevd, fd_idx, tp, fm, nv):
    if S.dim() != 4:
        raise ValueError(f"S must be [B, NST, D, W], got {tuple(S.shape)}")
    B, NST, D, W = S.shape
    want = {"S": (S, torch.float32, (B, NST, D, W)),
            "TF": (TF, torch.int32, (B, NST, D, W)),
            "CTX": (CTX, torch.int32, (B, NST, D, W)),
            "pre": (pre, torch.float32, (B, NST, D, W)),
            "tp": (tp, torch.float32, (NST * (NST + 1), D, W)),
            "fm": (fm, torch.bool, (D, W))}
    if VAR is not None:
        if prevd is None or fd_idx is None or nv is None:
            raise ValueError("VAR needs prevd, fd_idx and nv")
        if prevd.dim() != 4 or tuple(prevd.shape[:2]) != (B, NST):
            raise ValueError(f"prevd must be [B, NST, RF, NFD], got "
                             f"{tuple(prevd.shape)}")
        want["VAR"] = (VAR, torch.int32, (B, NST, W))
        want["prevd"] = (prevd, torch.float32, tuple(prevd.shape))
        want["fd_idx"] = (fd_idx, torch.int32, (W,))
        want["nv"] = (nv, torch.int32, (W,))
    for name, (x, dt, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")
        if x.dtype != dt:
            raise TypeError(f"{name}: dtype {x.dtype} != {dt}")
        if x.device != S.device:
            raise ValueError(f"{name}: device {x.device} != {S.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: not contiguous")


def chain_step(S, TF, CTX, VAR, pre, prevd, fd_idx, tp, fm, nv, pip):
    """Chain step on the tensors' device: the CUDA kernel for CUDA
    tensors, `chain_step_ref` for CPU tensors.  Same arguments and
    results as `chain_step_ref`."""
    global launches
    _check(S, TF, CTX, VAR, pre, prevd, fd_idx, tp, fm, nv)
    if S.device.type == "cpu":
        return chain_step_ref(S, TF, CTX, VAR, pre, prevd, fd_idx, tp, fm,
                              nv, pip)
    if S.device.type != "cuda":
        raise ValueError(f"chain_step: unsupported device {S.device}")
    lib = _lib()
    B, NST, D, W = S.shape
    has_var = VAR is not None
    nS = torch.empty_like(S)
    nTF = torch.empty_like(TF)
    nCX = torch.empty_like(CTX)
    dev = S.device
    nVAR = torch.empty((B, NST, W), dtype=torch.int32, device=dev)
    es = torch.empty((B, W), dtype=torch.float32, device=dev)
    etf = torch.empty((B, W), dtype=torch.int32, device=dev)
    ecx = torch.empty((B, W), dtype=torch.int32, device=dev)
    RF, NFD = (prevd.shape[2], prevd.shape[3]) if has_var else (0, 0)
    if B and W:
        ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.chain_step_launch(
                ptr(S), ptr(TF), ptr(CTX), ptr(VAR), ptr(pre), ptr(prevd),
                ptr(fd_idx), ptr(tp), ptr(fm), ptr(nv), float(pip),
                ptr(nS), ptr(nTF), ptr(nCX), ptr(nVAR), ptr(es), ptr(etf),
                ptr(ecx), B, NST, D, W, RF, NFD, int(has_var), stream)
        if err:
            raise RuntimeError("chain_step_launch: "
                               + lib.chain_error_string(err).decode())
        launches += 1
    return nS, nTF, nCX, nVAR, es, etf, ecx


def _lib():
    lib = _build.load("chain")
    if not getattr(lib, "_typed", False):
        lib.chain_step_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_float]
            + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
            + [ctypes.c_void_p])
        lib.chain_step_launch.restype = ctypes.c_int
        lib.chain_error_string.argtypes = [ctypes.c_int]
        lib.chain_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
