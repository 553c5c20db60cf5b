"""Word-transition block of the fused n-gram scan: CUDA kernel + plain
torch version.

The JAX scan computes this block with XLA ops (the "word transitions"
block of `pocketsphinx_tpu.search.ngram_fused.NgramFusedDecoder.
_make_scan`); it has no Pallas kernel.  Per utterance b and entry column
e, from this frame's top-K exits (scores kv, word ids ki, LM contexts
ctx_k, final base phones fb_k [B, K], right-context exit planes svk
[B, NRC, K]) and the block tables `tb`:

  * the LM row of each exit's context: mode "rows" the dense row
    rows[ctx]; mode "sparse" (B) the bigram row of the context's newest
    word + the trigram backoff; mode "csr" (C) the unigram row + the
    history's backoff with its CSR bigrams in place, or its dense "fat"
    row, + the trigram backoff; in modes B and C the context's trigram
    corrections then replace values (`tg2c`/`tg2v`, or the flat
    `tg_cols`/`tg_vals`);
  * cand[k] = ((svk[f0p[e], k] + (filler ? fillpen : lm + wpen))
    + (accept[fb_k, e] - 1) * 1e30) + (kv[k] live ? 0 : NEG_INF);
  * entry = max over k, am = its first k, and the winner's payloads:
    prw_e = ki[am], the successor context ctx_new (the winner's context
    row in modes rows/B, the CSR/fat context overlay in mode C; a filler
    keeps the source's context), the LM history erw1/erw2 and fb_e.

`transitions` launches `csrc/transitions.cu` for CUDA tensors and runs
`transitions_ref` only for CPU tensors; given `out=`, either writes into
the caller's seven [B, nE] tensors (a split decoder's static buffers on
a part's card, where a CUDA-graph capture may allocate nothing).  The tables are the decoder's
own or one part's of a "model" group (`convert.split_scan_tables`: its
column range, with scatter ids outside it sent to the spare column nE,
which is dropped).  Within one history's CSR row, and within one
context's trigram row, columns are unique: the overlays are then the
same whatever order they are applied in.  The kernel reads its own forms
of two tables: `accept_bits` [NW, E] (the accept table packed one bit
per CI phone, any number of phones) and the overlay lists with each row
sorted by column (`tr_bg_*`, `tr_tg_*`; `convert.kernel_overlays`),
which a block searches for its column tile.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .hmm import NEG_INF

#: the kernel's choices of entry columns per thread (`cols_per_thread`,
#: consecutive columns)
COLS_PER_THREAD = (1, 2, 4)
#: the kernel's choices of splits of a block's threads over the exits
#: (`k_split`; the splits' winners merge at the end)
K_SPLITS = (1, 2, 4, 8)
#: (columns per thread, splits) in the order the default tries them: the
#: widest column tile first
_SHAPES = ((4, 1), (4, 2), (4, 4), (4, 8), (2, 8), (1, 8))
#: threads per block of the kernel (TPB in csrc/transitions.cu)
_TPB = 256
#: the most exits staged in shared memory at once (the kernel loops over
#: chunks of a multiple of 32 exits)
_KC = 128
#: the most dynamic shared memory a block may take on an H100
_SMEM_BYTES = 232448
_MODES = {"rows": 0, "sparse": 1, "csr": 2}
#: the kernel's tables whose last axis is the entry columns
_E_TABLES = {"f0p_E", "isfill_E", "fillpen_E", "isreal_E", "lmwid_E",
             "accept_bits", "rows", "bg", "ctx_next", "fat_rows", "fat_ctx",
             "uni_row", "ctx_base"}
#: the dense table the kernel reads rows of, by LM mode
_DENSE = {"rows": "rows", "sparse": "bg", "csr": "fat_rows"}
#: the dtypes of the outputs (entry, am, prw_e, ctx_new, erw1, erw2, fb_e)
_OUT_DTYPES = (torch.float32, torch.int64, torch.int64, torch.int32,
               torch.int32, torch.int32, torch.int64)


class LMLayout(NamedTuple):
    """The static shape of the block's LM tables (the decoder's)."""
    mode: str          # "rows", "sparse" (B) or "csr" (C)
    V: int             # unigrams; context 0 is the empty history
    n_bg: int          # bigram contexts (bgmeta rows)
    s_tri: int         # the longest trigram-correction row
    sb: int            # the longest kept CSR bigram row (mode C)
    n_fat: int         # dense "fat" history rows (mode C)


def _csr_rows(tb, lm, h1c):
    """Mode C's bigram rows and successor-context rows [B, K, E] of the
    histories h1c [B, K] (V: the empty history) over the entry columns of
    `tb`, in the JAX step's order of float operations: the unigram row +
    the history's backoff, the CSR overlay scattered onto a spare column,
    then the fat rows in place of both rows."""
    nE = tb["isfill_E"].shape[0]
    B, K = h1c.shape
    um = tb["umeta"][h1c]                                     # [B, K, 4]
    base = tb["uni_row"] + um[..., 2].contiguous().view(
        torch.float32)[..., None]
    ctxrow = tb["ctx_base"].expand(B, K, nE)
    if lm.sb:
        pos = torch.arange(lm.sb, device=h1c.device)
        at = um[..., 0:1].long() + pos                        # [B, K, SB]
        ok = pos < um[..., 1:2]
        idx = torch.where(ok, tb["bg_cols"][at], nE)
        rows = []
        for row, vals in ((base, tb["bg_vals"]), (ctxrow, tb["bg_ctx"])):
            row = torch.cat([row, row.new_zeros((B, K, 1))], 2)
            row.scatter_(2, idx, torch.where(ok, vals[at], 0.0))
            rows.append(row[..., :nE])
        base, ctxrow = rows
    if lm.n_fat:
        fat = um[..., 3]
        isfat = (fat >= 0)[..., None]
        fidx = torch.clamp(fat, 0, lm.n_fat - 1).long()
        base = torch.where(isfat, tb["fat_rows"][fidx], base)
        ctxrow = torch.where(isfat, tb["fat_ctx"][fidx], ctxrow)
    return base, ctxrow


def transitions_ref(tb, lm, kv, ki, ctx_k, fb_k, svk, wpen, out=None):
    """Plain torch version of the block (see module docstring).

    tb: block tables; lm: `LMLayout`; kv [B, K] f32, ki [B, K] i64,
    ctx_k [B, K] i32, fb_k [B, K] i64, svk [B, NRC, K] f32; wpen: the
    word insertion penalty (a float32 value).
    Returns (entry f32, am i64, prw_e i64, ctx_new i32, erw1 i32,
    erw2 i32, fb_e i64), each [B, nE]: in the tensors of `out` (seven
    such tensors, `_check_out`) when given."""
    nE = tb["isfill_E"].shape[0]
    B, K = ki.shape
    V = lm.V
    dev = ki.device
    exg = svk.transpose(1, 2)[:, :, tb["f0p_E"]]              # [B, K, E]
    if lm.mode == "rows":
        lmrow = tb["rows"][ctx_k.long()]                      # [B, K, E]
        rh = tb["rows_h"][ctx_k.long()]                       # [B, K, 2]
        rw1_k = rh[..., 0].to(torch.int32)
        rw2_k = rh[..., 1].to(torch.int32)
    else:
        # modes B and C: the bigram row of the context's newest word
        # (+ trigram backoff), then the sparse per-context trigram
        # overrides
        is_tri = ctx_k > V
        bidx = torch.clamp(ctx_k - 1 - V, 0, max(lm.n_bg - 1, 0)).long()
        meta = tb["bgmeta"][bidx]                             # [B, K, 8]
        rw1_k = torch.where(is_tri, meta[..., 0],
                            torch.where(ctx_k > 0, ctx_k - 1, V)
                            .to(torch.int32))
        rw2_k = torch.where(is_tri, meta[..., 1], V).to(torch.int32)
        bo2w_v = meta[..., 2].contiguous().view(torch.float32)
        h1c = torch.clamp(rw1_k, max=V).long()
        if lm.mode == "csr":
            base, ctxrow = _csr_rows(tb, lm, h1c)
        else:
            base = tb["bg"][h1c]                              # [B, K, E]
        lmrow = base + torch.where(is_tri, bo2w_v, 0.0)[..., None]
        if lm.s_tri:
            S_TRI = lm.s_tri
            if "tg2c" in tb:
                wc, wv = tb["tg2c"][bidx], tb["tg2v"][bidx]   # [B, K, S]
            else:
                pos0 = (meta[..., 3:4].long()
                        + torch.arange(S_TRI, device=dev))
                wc, wv = tb["tg_cols"][pos0], tb["tg_vals"][pos0]
            pos = torch.arange(S_TRI, device=dev)
            ok = (pos < meta[..., 4:5]) & is_tri[..., None]
            idx = torch.where(ok, wc, nE).long()
            lmp = torch.cat([lmrow, lmrow.new_zeros((B, K, 1))], 2)
            lmp.scatter_(2, idx, torch.where(ok, wv, 0.0))
            lmrow = lmp[..., :nE]
    if lm.mode != "csr":
        ctxrow = tb["ctx_next"][torch.clamp(rw1_k, min=0).long()]
    accm = tb["accept_T"][fb_k]                               # [B, K, E]
    cand = (exg + torch.where(tb["isfill_E"], tb["fillpen_E"],
                              lmrow + wpen)
            + (accm - 1.0) * 1e30
            + torch.where(kv > NEG_INF / 2, 0.0, NEG_INF)[..., None])
    # first-winner entry per column: one argmax over K, payload gathers
    entry, am = torch.max(cand, dim=1)                        # [B, E]
    prw_e = torch.gather(ki, 1, am)
    srcctx = torch.gather(ctx_k, 1, am)
    srcrw1 = torch.gather(rw1_k, 1, am)
    srcrw2 = torch.gather(rw2_k, 1, am)
    fb_e = torch.gather(fb_k, 1, am)
    ctxsel = torch.gather(ctxrow, 1, am[:, None, :])[:, 0]
    ctx_new = torch.where(tb["isfill_E"], srcctx, ctxsel.to(torch.int32))
    erw1 = torch.where(tb["isreal_E"], tb["lmwid_E"], srcrw1)
    # fillers inherit the source's full history; real words shift it
    erw2 = torch.where(tb["isreal_E"], srcrw1, srcrw2)
    res = entry, am, prw_e, ctx_new, erw1, erw2, fb_e
    if out is None:
        return res
    _check_out(out, B, nE, dev)
    for o, r in zip(out, res):
        o.copy_(r)
    return out


def _check_exits(kv, ki, ctx_k, fb_k, svk):
    if kv.dim() != 2:
        raise ValueError(f"kv must be [B, K], got {tuple(kv.shape)}")
    B, K = kv.shape
    if K == 0:
        raise ValueError("transitions: no exits (K = 0)")
    if svk.dim() != 3 or svk.shape[0] != B or svk.shape[2] != K:
        raise ValueError(f"svk must be [B, NRC, K] = [{B}, NRC, {K}], got "
                         f"{tuple(svk.shape)}")
    for name, x, dt in (("kv", kv, torch.float32), ("ki", ki, torch.int64),
                        ("ctx_k", ctx_k, torch.int32),
                        ("fb_k", fb_k, torch.int64),
                        ("svk", svk, torch.float32)):
        if name != "svk" and tuple(x.shape) != (B, K):
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {(B, K)}")
        if x.dtype != dt:
            raise TypeError(f"{name}: dtype {x.dtype} != {dt}")
        if x.device != kv.device:
            raise ValueError(f"{name}: device {x.device} != {kv.device}")


def _check_out(out, B, nE, device):
    """Raises unless `out` holds the block's seven outputs, [B, nE] each,
    contiguous, on `device`, with `outputs`' dtypes."""
    if len(out) != len(_OUT_DTYPES):
        raise ValueError(f"transitions: out holds {len(out)} tensors, not "
                         f"{len(_OUT_DTYPES)}")
    for i, (o, dt) in enumerate(zip(out, _OUT_DTYPES)):
        if tuple(o.shape) != (B, nE) or o.dtype != dt:
            raise ValueError(f"transitions: out[{i}] is {tuple(o.shape)} "
                             f"{o.dtype}, not {(B, nE)} {dt}")
        if o.device != device or not o.is_contiguous():
            raise ValueError(f"transitions: out[{i}] must be contiguous on "
                             f"{device}")


def _kernel_tables(tb, lm, device):
    """The tables the kernel reads, checked: {name: tensor}."""
    nE = tb["isfill_E"].shape[0]
    want = {"f0p_E": torch.int64, "isfill_E": torch.bool,
            "fillpen_E": torch.float32, "isreal_E": torch.bool,
            "lmwid_E": torch.int32, "accept_bits": torch.int64}
    if lm.mode == "rows":
        want.update(rows=torch.float32, rows_h=torch.float32,
                    ctx_next=torch.float32)
    else:
        want["bgmeta"] = torch.int32
        if lm.mode == "sparse":
            want.update(bg=torch.float32, ctx_next=torch.float32)
        else:
            want.update(uni_row=torch.float32, ctx_base=torch.float32,
                        umeta=torch.int32, tr_bg_cols=torch.int32,
                        tr_bg_vals=torch.float32, tr_bg_ctx=torch.float32,
                        fat_rows=torch.float32, fat_ctx=torch.float32)
        if lm.s_tri:
            want.update(tr_tg_cols=torch.int32, tr_tg_vals=torch.float32)
    out = {}
    for name, dt in want.items():
        x = tb.get(name)
        if x is None:
            raise ValueError(f"transitions: table {name} missing (mode "
                             f"{lm.mode}; `accept_bits` needs a 0/1 "
                             f"accept table)")
        if x.dtype != dt:
            raise TypeError(f"transitions: {name} dtype {x.dtype} != {dt}")
        if x.device != device:
            raise ValueError(f"transitions: {name} on {x.device}, exits on "
                             f"{device}")
        if not x.is_contiguous():
            raise ValueError(f"transitions: {name} not contiguous")
        if name in _E_TABLES and x.shape[-1] != nE:
            raise ValueError(f"transitions: {name} has {x.shape[-1]} "
                             f"columns, not {nE}")
        if name == "tr_tg_cols" and x.dim() == 2 and x.shape[1] != lm.s_tri:
            raise ValueError(f"transitions: tr_tg_cols rows of "
                             f"{x.shape[1]}, not S_TRI = {lm.s_tri}")
        out[name] = x
    return out


class _Args(ctypes.Structure):
    """`struct Args` of csrc/transitions.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "kv", "ki", "ctx", "fb", "svk",
        "f0p", "isfill", "fillpen", "isreal", "lmwid", "acc",
        "rows", "rows_h", "bg", "ctx_next", "bgmeta",
        "uni_row", "ctx_base", "umeta", "bg_cols", "bg_vals", "bg_ctx",
        "fat_rows", "fat_ctx", "tg_cols", "tg_vals",
        "entry", "am", "prw", "ctx_new", "erw1", "erw2", "fb_e")] + [
        (n, ctypes.c_int64) for n in ("kv_ld", "ki_ld", "ctx_ld",
                                      "fb_ld")] + [
        (n, ctypes.c_int32) for n in ("B", "K", "NRC", "nE", "V", "n_bg",
                                      "s_tri", "sb", "n_fat", "tg2d",
                                      "kc", "nw", "ks", "vec")] + [
        ("wpen", ctypes.c_float)]


def launch_shape(B, nE, K, n_sm):
    """The kernel's default (columns per thread, exit splits): the widest
    column tile (`_SHAPES` in order) whose grid has a block for each of
    `n_sm` multiprocessors, splitting the exits only while each split
    keeps 8 or more of the K exits; else the last one tried (the most
    blocks).  A wider tile shares each exit's staging and overlay search
    among more columns (on an H100 the widest was fastest at 20k and
    126k columns, B=8, K=96), but the grid must fill the card (1.7k)."""
    best = _SHAPES[0]
    for cpt, ks in _SHAPES:
        if ks > 1 and K < 8 * ks:
            break
        best = (cpt, ks)
        if B * -(-nE // (_TPB // ks * cpt)) >= n_sm:
            break
    return best


def transitions(tb, lm, kv, ki, ctx_k, fb_k, svk, wpen,
                cols_per_thread=None, k_split=None, out=None):
    """The block on the tensors' device: the CUDA kernel for CUDA
    tensors, `transitions_ref` for CPU tensors.  Same arguments and
    results as `transitions_ref`; `cols_per_thread` (one of
    `COLS_PER_THREAD`) and `k_split` (one of `K_SPLITS`) set the
    kernel's entry columns per thread and splits of the exits (default:
    `launch_shape` of the shapes, each given value in place of its own).
    The [B, K] exits may be row views (stride 1 along K).  With `out`
    the kernel writes into its seven tensors and the call allocates
    nothing on the card, as a CUDA-graph capture on a card other than
    the capturing one needs."""
    _check_exits(kv, ki, ctx_k, fb_k, svk)
    dev = kv.device
    if dev.type == "cpu":
        return transitions_ref(tb, lm, kv, ki, ctx_k, fb_k, svk, wpen, out)
    if dev.type != "cuda":
        raise ValueError(f"transitions: unsupported device {dev}")
    if lm.mode not in _MODES:
        raise ValueError(f"transitions: unknown LM mode {lm.mode!r}")
    if cols_per_thread is not None and cols_per_thread not in \
            COLS_PER_THREAD:
        raise ValueError(f"transitions: cols_per_thread {cols_per_thread} "
                         f"not in {COLS_PER_THREAD}")
    if k_split is not None and k_split not in K_SPLITS:
        raise ValueError(f"transitions: k_split {k_split} not in "
                         f"{K_SPLITS}")
    for name, x in (("kv", kv), ("ki", ki), ("ctx_k", ctx_k),
                    ("fb_k", fb_k)):
        if kv.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(f"transitions: {name}'s rows must be "
                             f"contiguous")
    if not svk.is_contiguous():
        raise ValueError("transitions: svk not contiguous")
    t = _kernel_tables(tb, lm, dev)
    B, K = kv.shape
    NRC = svk.shape[1]
    nE = t["isfill_E"].shape[0]
    nw = t["accept_bits"].shape[0]
    cpt, ks = launch_shape(B, nE, K, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    cpt = cols_per_thread or cpt
    ks = k_split or ks
    kc = min(-(-K // 32) * 32, _KC)
    if _smem_bytes(lm.mode, kc, NRC, cpt, ks, nw) > _SMEM_BYTES:
        raise ValueError(f"transitions: NRC = {NRC} exit planes (and {nw} "
                         f"accept words per column) do not fit in shared "
                         f"memory")
    if out is None:
        outs = outputs(B, nE, dev)
    else:
        _check_out(out, B, nE, dev)
        outs = tuple(out)
    if not (B and nE):
        return outs
    a = _launch_args(t, lm, kv, ki, ctx_k, fb_k, svk, wpen, outs, kc, ks,
                     _vec(t, lm, cpt))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.transitions_launch(ctypes.byref(a), _MODES[lm.mode],
                                     cpt, stream)
    if err:
        raise RuntimeError("transitions_launch: "
                           + lib.transitions_error_string(err).decode())
    _build.launched("transitions")
    return outs


def outputs(B, nE, dev):
    """(entry, am, prw_e, ctx_new, erw1, erw2, fb_e) [B, nE], empty: the
    block's outputs, or buffers for its `out`."""
    return tuple(torch.empty((B, nE), dtype=dt, device=dev)
                 for dt in _OUT_DTYPES)


def _vec(t, lm, cpt):
    """Whether the kernel may read `cpt` columns of a dense LM row in one
    aligned load: every row starts on a multiple of `cpt` columns."""
    x = t[_DENSE[lm.mode]]
    return x.shape[-1] % cpt == 0 and x.data_ptr() % (4 * cpt) == 0


def _launch_args(t, lm, kv, ki, ctx_k, fb_k, svk, wpen, outs, kc, ks=1,
                 vec=False):
    """The kernel's `Args` over the checked tables `t`, the exits and
    the outputs `outs`, with `kc` exits staged at a time, `ks` splits of
    the exits and (`vec`) vector loads of the dense rows."""
    ptr = lambda n: t[n].data_ptr() if n in t else None  # noqa: E731
    tg2d = "tr_tg_cols" in t and t["tr_tg_cols"].dim() == 2
    B, K = kv.shape
    return _Args(
        kv=kv.data_ptr(), ki=ki.data_ptr(), ctx=ctx_k.data_ptr(),
        fb=fb_k.data_ptr(), svk=svk.data_ptr(),
        f0p=ptr("f0p_E"), isfill=ptr("isfill_E"), fillpen=ptr("fillpen_E"),
        isreal=ptr("isreal_E"), lmwid=ptr("lmwid_E"),
        acc=ptr("accept_bits"), rows=ptr("rows"), rows_h=ptr("rows_h"),
        bg=ptr("bg"), ctx_next=ptr("ctx_next"), bgmeta=ptr("bgmeta"),
        uni_row=ptr("uni_row"), ctx_base=ptr("ctx_base"),
        umeta=ptr("umeta"), bg_cols=ptr("tr_bg_cols"),
        bg_vals=ptr("tr_bg_vals"), bg_ctx=ptr("tr_bg_ctx"),
        fat_rows=ptr("fat_rows"), fat_ctx=ptr("fat_ctx"),
        tg_cols=ptr("tr_tg_cols"), tg_vals=ptr("tr_tg_vals"),
        entry=outs[0].data_ptr(), am=outs[1].data_ptr(),
        prw=outs[2].data_ptr(), ctx_new=outs[3].data_ptr(),
        erw1=outs[4].data_ptr(), erw2=outs[5].data_ptr(),
        fb_e=outs[6].data_ptr(),
        kv_ld=kv.stride(0), ki_ld=ki.stride(0), ctx_ld=ctx_k.stride(0),
        fb_ld=fb_k.stride(0), B=B, K=K, NRC=svk.shape[1],
        nE=outs[0].shape[1], V=lm.V, n_bg=lm.n_bg, s_tri=lm.s_tri,
        sb=lm.sb, n_fat=lm.n_fat, tg2d=int(tg2d), kc=kc,
        nw=t["accept_bits"].shape[0], ks=ks, vec=int(vec), wpen=wpen)


def _smem_bytes(mode, kc, nrc, cpt, ks, nw):
    """Dynamic shared memory of one block (`layout` in the source), each
    region rounded up to 16 bytes: 16 words per staged exit; its exit
    planes [nrc][kc + 4]; the overlaid-pair masks ([kc / 32][tile] words,
    mode B one set, mode C two), which the splits' winners ([ks][tile]
    (float, int)) reuse at the end; mode B and C's overlay winner key
    (8 bytes a column) and mode C's its context (4) and fat-exit bits
    (16 bytes); the accept words
    (2 * nw 32-bit words a column) unless one word per column is held
    in registers."""
    up = lambda x: -(-x // 16) * 16  # noqa: E731
    tile = _TPB // ks * cpt
    masks = 4 * {"rows": 0, "sparse": 1, "csr": 2}[mode] * kc // 32 * tile
    n = up(64 * kc) + up(4 * nrc * (kc + 4)) + up(max(masks, 8 * ks * tile))
    n += {"rows": 0, "sparse": 8 * tile, "csr": 12 * tile + 16}[mode]
    return n + (8 * nw * tile if nw > 1 else 0)


def _lib():
    lib = _build.load("transitions")
    if not getattr(lib, "_typed", False):
        lib.transitions_launch.argtypes = [ctypes.POINTER(_Args),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
        lib.transitions_launch.restype = ctypes.c_int
        lib.transitions_error_string.argtypes = [ctypes.c_int]
        lib.transitions_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
