"""Chain-bucket step: CUDA kernel + plain torch versions.

Port of `pocketsphinx_tpu.ops.pallas_chain` (the Pallas `_kernel`
reached through its `chain_step`), and of the XLA chain block of the JAX
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

A frame's chain block is one grouped call over every bucket,
`chain_group_step`.  Its carry fields are flat buffers, the buckets'
[B, NST, D, W] blocks end to end (VAR: the variant buckets' [B, NST, W]
blocks), and `ChainGroup` holds the static layout: the bucket table the
kernel reads and the flat unbatched tables.  `chain_group_step` launches
`csrc/chain.cu` once for CUDA tensors and runs `chain_group_ref`
(`chain_step_ref` over each bucket's views) only for CPU tensors.  `tp`,
`fm`, `nv` and `fd_idx` are shared by the batch and must be unbatched.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .hmm import NEG_INF, hmm_step_sm

#: launches of the CUDA kernel since the last reset (plain int); a
#: replay of the scan's CUDA graph adds the launches its capture made,
#: which counted in the capturing thread's `_build.tally` instead
#: (`search.ngram_fused._ScanGraph`)
launches = 0

#: columns of a row of the bucket table (`enum` in csrc/chain.cu)
TAB_COLUMNS = ("D", "W", "has_var", "RF", "NFD", "blk0", "carry", "var",
               "pre", "prevd", "tp", "fm", "woff", "xcol")
N_COL = 16
#: words per block of the kernel
WT = 32


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


class ChainGroup:
    """Static layout of a frame's chain buckets for one grouped step.

    NST: states per node.  buckets, in layout order: dicts with
    tp [NST*(NST+1), D, W] f32 and fm [D, W] bool, and for a bucket with
    variants also nv [W], fd_idx [W] (int32) and RF, NFD (its prevd
    planes' shape); all on one device.

    Per batch element, in layout order:
      * carry planes S/TF/CTX: NST*D*W per bucket (`planes`);
      * VAR: NST*W per variant bucket (`var_planes`);
      * the g row: pre [NST, D, W] of every bucket, then prevd
        [NST, RF, NFD] of every variant bucket (`g_width` in all);
      * exits: group 0 holds the variant buckets' words, group 1 the
        others' (`n_exit`), each bucket's at its offset `xcol`.
    `row` lays per-bucket parts out as the g row.  The table `tab`
    [n_buckets, N_COL] int32 has one row per bucket in launch order, the
    deepest buckets first (their serial walks then overlap the wide
    buckets' streaming); column `blk0` is the bucket's first block (WT
    words each)."""

    def __init__(self, NST: int, buckets):
        self.NST = NST
        rows = []
        at = dict(carry=0, var=0, pre=0, tp=0, fm=0, woff=0)
        xcol = [0, 0]
        for b in buckets:
            if b["tp"].dim() != 3 or b["tp"].shape[0] != NST * (NST + 1):
                raise ValueError(f"tp must be unbatched [{NST * (NST + 1)}, "
                                 f"D, W], got {tuple(b['tp'].shape)}")
            NK, D, W = b["tp"].shape
            has_var = b.get("nv") is not None
            r = dict(D=D, W=W, has_var=int(has_var),
                     RF=b["RF"] if has_var else 0,
                     NFD=b["NFD"] if has_var else 0,
                     xcol=xcol[not has_var], prevd=0, **at)
            if not has_var:
                r["var"] = r["woff"] = 0
            rows.append(r)
            at["carry"] += NST * D * W
            at["pre"] += NST * D * W
            at["tp"] += NK * D * W
            at["fm"] += D * W
            if has_var:
                at["var"] += NST * W
                at["woff"] += W
            xcol[not has_var] += W
        width = at["pre"]
        for r in rows:
            if r["has_var"]:
                r["prevd"] = width
                width += NST * r["RF"] * r["NFD"]
        order = sorted(range(len(rows)), key=lambda i: -rows[i]["D"])
        blk = 0
        for i in order:
            rows[i]["blk0"] = blk
            blk += -(-rows[i]["W"] // WT)
        tab = np.zeros((len(rows), N_COL), np.int64)
        for pos, i in enumerate(order):
            tab[pos, :len(TAB_COLUMNS)] = [rows[i][c] for c in TAB_COLUMNS]
        if tab.size and tab.max() >= 2 ** 31:
            raise ValueError("chain group too large for int32 offsets")
        self.rows = rows
        self.order = order
        self._view_specs = {}
        self.n_blocks = blk
        self.n_carry, self.n_var = at["carry"], at["var"]
        self.g_width = width
        self.n_exit = tuple(xcol)
        dev = buckets[0]["tp"].device if buckets else torch.device("cpu")
        self.tab = torch.as_tensor(tab.astype(np.int32), device=dev)

        def flat(key, dt, which):
            xs = [b[key].reshape(-1).to(dt) for b in which]
            return torch.cat(xs) if xs else torch.zeros(0, dtype=dt,
                                                        device=dev)

        var_b = [b for b in buckets if b.get("nv") is not None]
        self.tp = flat("tp", torch.float32, buckets)
        self.fm = flat("fm", torch.bool, buckets)
        self.nv = flat("nv", torch.int32, var_b)
        self.fd_idx = flat("fd_idx", torch.int32, var_b)
        # per-bucket views of the flat tables, for the plain version
        NK = NST * (NST + 1)
        self.tp_b = [self.tp[r["tp"]:r["tp"] + NK * r["D"] * r["W"]]
                     .view(NK, r["D"], r["W"]) for r in rows]
        self.fm_b = [self.fm[r["fm"]:r["fm"] + r["D"] * r["W"]]
                     .view(r["D"], r["W"]) for r in rows]
        self.nv_b = [self.nv[r["woff"]:r["woff"] + r["W"]]
                     if r["has_var"] else None for r in rows]
        self.fd_b = [self.fd_idx[r["woff"]:r["woff"] + r["W"]]
                     if r["has_var"] else None for r in rows]

    @property
    def n_buckets(self):
        return len(self.rows)

    def row(self, pre, prevd):
        """The g row [..., g_width] of per-bucket parts: `pre`, one
        [..., NST*D*W] tensor per bucket, and `prevd`, one
        [..., NST*RF*NFD] tensor per variant bucket, in layout order."""
        g = torch.cat(list(pre) + list(prevd), -1)
        if g.shape[-1] != self.g_width:
            raise ValueError(f"g row of width {g.shape[-1]}, not the "
                             f"group's {self.g_width}")
        return g

    def _views(self, B, var):
        """(shape, stride, offset) of each bucket's view of a flat carry
        field (`var`: of the variant buckets' VAR blocks), cached per B:
        the scan makes these views every frame."""
        key = (B, var)
        if key not in self._view_specs:
            N, specs = self.NST, []
            for r in self.rows:
                if var and not r["has_var"]:
                    continue
                D, W = (1, r["W"]) if var else (r["D"], r["W"])
                shape = (B, N, W) if var else (B, N, D, W)
                stride = (N * D * W, D * W, 1) if var else \
                    (N * D * W, D * W, W, 1)
                specs.append((shape, stride, B * r["var" if var else "carry"]))
            self._view_specs[key] = specs
        return self._view_specs[key]

    def planes(self, x, B):
        """Per-bucket [B, NST, D, W] views of a flat carry field."""
        o = x.storage_offset()
        return [x.as_strided(shape, stride, o + off)
                for shape, stride, off in self._views(B, False)]

    def var_planes(self, x, B):
        """Per-variant-bucket [B, NST, W] views of the flat VAR field."""
        o = x.storage_offset()
        return [x.as_strided(shape, stride, o + off)
                for shape, stride, off in self._views(B, True)]

    def init_carry(self, B):
        """Flat carry fields at frame 0: every token dead (S = NEG_INF,
        TF/CTX/VAR = 0)."""
        dev, n = self.tab.device, B * self.n_carry
        return dict(
            S=torch.full((n,), NEG_INF, dtype=torch.float32, device=dev),
            TF=torch.zeros(n, dtype=torch.int32, device=dev),
            CTX=torch.zeros(n, dtype=torch.int32, device=dev),
            VAR=torch.zeros(B * self.n_var, dtype=torch.int32, device=dev))


def chain_group_ref(grp, S, TF, CTX, VAR, g, pip):
    """Plain torch version of the grouped chain step: `chain_step_ref`
    over each bucket's views.  Same arguments and results as
    `chain_group_step`."""
    B, N = g.shape[0], grp.NST
    dev = g.device
    sv, tfv, cxv = grp.planes(S, B), grp.planes(TF, B), grp.planes(CTX, B)
    varv = iter(grp.var_planes(VAR, B))
    flat = ([], [], [], [])
    exits = ([[], [], []], [[], [], []])
    for k, r in enumerate(grp.rows):
        D, W = r["D"], r["W"]
        pre = g[:, r["pre"]:r["pre"] + N * D * W].view(B, N, D, W)
        var = prevd = None
        if r["has_var"]:
            var = next(varv)
            n = N * r["RF"] * r["NFD"]
            prevd = g[:, r["prevd"]:r["prevd"] + n].view(
                B, N, r["RF"], r["NFD"])
        o = chain_step_ref(sv[k], tfv[k], cxv[k], var, pre, prevd,
                           grp.fd_b[k], grp.tp_b[k], grp.fm_b[k],
                           grp.nv_b[k], pip)
        for i in range(3 + r["has_var"]):
            flat[i].append(o[i].reshape(-1))
        for i in range(3):
            exits[not r["has_var"]][i].append(o[4 + i])

    def cat(xs, dt):
        return torch.cat(xs) if xs else torch.zeros(0, dtype=dt, device=dev)

    def cat1(xs, dt):
        return (torch.cat(xs, 1) if xs
                else torch.zeros((B, 0), dtype=dt, device=dev))

    f32, i32 = torch.float32, torch.int32
    return (cat(flat[0], f32), cat(flat[1], i32), cat(flat[2], i32),
            cat(flat[3], i32),
            *(cat1(x, dt) for grp_x in exits
              for x, dt in zip(grp_x, (f32, i32, i32))))


def _check_group(grp, S, TF, CTX, VAR, g):
    if g.dim() != 2:
        raise ValueError(f"g must be [B, g_width], got {tuple(g.shape)}")
    B = g.shape[0]
    want = {"S": (S, torch.float32, (B * grp.n_carry,)),
            "TF": (TF, torch.int32, (B * grp.n_carry,)),
            "CTX": (CTX, torch.int32, (B * grp.n_carry,)),
            "VAR": (VAR, torch.int32, (B * grp.n_var,)),
            "g": (g, torch.float32, (B, grp.g_width))}
    dev = grp.tab.device
    for name, (x, dt, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")
        if x.dtype != dt:
            raise TypeError(f"{name}: dtype {x.dtype} != {dt}")
        if x.device != dev:
            raise ValueError(f"{name}: device {x.device} != the group's "
                             f"tables' {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: not contiguous")


def chain_group_step(grp, S, TF, CTX, VAR, g, pip):
    """The chain step of every bucket of `grp` (a `ChainGroup`) on the
    tensors' device: one launch of the CUDA kernel for CUDA tensors,
    `chain_group_ref` for CPU tensors.

    S/TF/CTX [B * grp.n_carry] f32/i32/i32 flat carry; VAR
    [B * grp.n_var] i32 (None when the group has no variant bucket);
    g [B, grp.g_width] f32 this frame's pre and prevd costs; pip float.
    Returns (newS, newTF, newCTX, newVAR flat,
             exit score, TF, CTX [B, n_exit[0]] of the variant buckets,
             exit score, TF, CTX [B, n_exit[1]] of the others)."""
    global launches
    if VAR is None:
        VAR = torch.zeros(0, dtype=torch.int32, device=S.device)
    _check_group(grp, S, TF, CTX, VAR, g)
    if S.device.type == "cpu":
        return chain_group_ref(grp, S, TF, CTX, VAR, g, pip)
    if S.device.type != "cuda":
        raise ValueError(f"chain_group_step: unsupported device {S.device}")
    lib = _lib()
    B, dev = g.shape[0], S.device
    nS = torch.empty_like(S)
    nTF = torch.empty_like(TF)
    nCX = torch.empty_like(CTX)
    nVAR = torch.empty_like(VAR)
    n0, n1 = grp.n_exit
    # score bits, TF and CTX of a group's exits in one int32 buffer
    x0 = torch.empty((3, B, n0), dtype=torch.int32, device=dev)
    x1 = torch.empty((3, B, n1), dtype=torch.int32, device=dev)
    if B and grp.n_blocks:
        # the launch goes to the current device: make it the tensors'
        with torch.cuda.device(dev):
            err = lib.chain_group_launch(
                grp.tab.data_ptr(), grp.n_buckets, grp.n_blocks, grp.NST, B,
                S.data_ptr(), TF.data_ptr(), CTX.data_ptr(), VAR.data_ptr(),
                g.data_ptr(), g.stride(0), grp.tp.data_ptr(),
                grp.fm.data_ptr(), grp.nv.data_ptr(), grp.fd_idx.data_ptr(),
                float(pip), nS.data_ptr(), nTF.data_ptr(), nCX.data_ptr(),
                nVAR.data_ptr(), x0.data_ptr(), n0, x1.data_ptr(), n1,
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError("chain_group_launch: "
                               + lib.chain_error_string(err).decode())
        if not _build.tallied("chain"):
            launches += 1
    (es0, tf0, cx0), (es1, tf1, cx1) = x0.unbind(0), x1.unbind(0)
    return (nS, nTF, nCX, nVAR, es0.view(torch.float32), tf0, cx0,
            es1.view(torch.float32), tf1, cx1)


def _lib():
    lib = _build.load("chain")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.chain_group_launch.argtypes = (
            [p] + [i] * 4 + [p] * 5 + [ctypes.c_longlong] + [p] * 4
            + [ctypes.c_float] + [p] * 4 + [p, i, p, i, p])
        lib.chain_group_launch.restype = ctypes.c_int
        lib.chain_error_string.argtypes = [ctypes.c_int]
        lib.chain_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
