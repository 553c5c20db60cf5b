"""Exact-trigram fused Viterbi n-gram search ("ngram_fused") in torch.

Port of `pocketsphinx_tpu.search.ngram_fused`.  The host-side network
build (`_build`, `_lm_tables`, `_guard_tables` and the table assembly of
the JAX `_make_scan`) is a NumPy copy; the per-frame scan step, its
chunked senone pre-gather, `init_carry`, the records and the 1-best
backtraces are torch, with the batch axis written out ([B, ...]) where
the JAX package used `jax.vmap`.  The pre-gather takes the finals' and
the single-phone columns' costs; the chain kernel reads its nodes'
costs by id from the frame's cost row (the JAX scan pre-gathers those
too).

The network (see the JAX module's docstring for the design):
  * right-aligned chain buckets [NST, D, Wb] for the first and interior
    phones of every multi-phone word, with the mpx first phone's variant
    carried as a VAR plane -- stepped, with the CI chains, by one launch
    of the chain kernel per frame (`ops/chain.py`, CUDA on the card) on a
    flat carry (the buckets' [B, NST, D, Wb] blocks end to end);
  * the word-final right-context fan [NST, n_rc, n_multi] -- stepped by
    the fan step (`ops/fan.py`: the fan kernel on the card, built for
    3- and 5-state models; its plain version on the CPU, at any number
    of states) on a carry padded to `fan.padded_width(n_multi)` columns
    (as the JAX scan pads its fan carry to the Pallas tile), which writes
    its exit plane into the step's [B, n_rc, W] exit planes and reduces
    the renormalization's max over its planes (the JAX package runs its
    Pallas fan only at 3 states and its XLA finals block otherwise);
  * single-phone words as explicit left-context columns, CI/filler words
    as chains without variants (in the same chain launch);
  * top-K word exits per frame, exact trigram successor rows (LM mode
    "rows": one dense row per history; mode "sparse" (B): dense bigram
    rows + per-context trigram overrides; mode "csr" (C): the unigram
    row + history backoff with per-history CSR bigram overlays, dense
    "fat" rows for giant-fanout histories, and the same trigram
    overrides), first-winner entries.

Every one-hot matrix product of the JAX step picks exactly one element
per output and is an index gather here; `jax.lax.top_k` is a stable
descending sort (ties to the lower index, like top_k); argmax is
first-max.  Given the same cost matrix the records are bit-equal to the
JAX package's (tests/test_torch_ngram_fused.py).

The renormalization (each frame's best score `m`, subtracted from every
score of the carry) is deferred for the carries the kernels read: the
chain carry and the fan carry.  The step leaves `m` pending in the carry
(`carry["m_prev"]` [B]) and the next frame's chain and fan steps
subtract it from each score as they load it: the same float32
subtraction before the same additions, so every score is bit-equal to
subtracting it in a pass over the carry, which the step then no longer
makes.  The single-phone columns still take the subtraction in the step.
A carry that leaves the scan (`with_carry`) has its pending offset
subtracted, one pass per call, so callers see the carry as the JAX scan
keeps it.  Counters, counted on the host: "scan.renorm_folded" (frames
whose chain and fan carries took the offset in the steps' load),
"scan.renorm_passes" (those folds at a carry's exit),
"scan.finals_kernel" (frames whose word-final block the fan step
stepped) and "scan.pregather_bytes" (the bytes each chunk's pre-gather
writes).

The scan runs in chunks of CHUNK frames, each with its senone
pre-gather (`_steps`), through the decoder's `base.ChunkGraph` of its
(B, n_sen): on a CUDA decoder one chunk is captured once per (records,
mask) as a CUDA graph over the runner's static buffers and replayed for
every chunk, as the JAX package compiles its scan once with `jax.jit`;
the frame index is then a device value.  A decoder split over a "model"
group (`shard`) captures the same chunk with every part's
word-transition block in it, on static buffers of each part
(`_SplitBuffers`): one graph over the group's cards, as the JAX package
compiles its scan over a "model" mesh.  On the CPU, and with
`graph=False` (a constructor or method argument), the same chunk runs on
the same buffers without capture.

Streaming: `with_carry` runs the scan from a carry and a frame offset
and returns the carry (the JAX `_make_scan(mask_carry=True).with_carry`);
a frame whose `valid` is false leaves the whole carry as it was.
`_backtrace` is the host 1-best walk over flat records (the JAX
`ngram_flat` walk, without the C extension).

The exactness guard's opt-in refinement PS_GUARD_TOPM (exact per-word
bonus rows for the exits ranked K..K+GM) changes only the `nviol`
count.  Everything of the JAX module is ported.
"""

from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from .. import profile, resolve_device
from ..convert import column_ranges, scan_tables, split_scan_tables
from ..models.dict2pid import Dict2Pid
from ..models.acoustic import AcousticModel, UNIT_NATS, senone_scores
from ..lm.ngram import NgramModel
from ..ops import transitions as transitions_ops
from ..ops.chain import ChainGroup, chain_group_step
from ..ops.fan import fan_step, padded_width
from ..ops.hmm import hmm_step_sm
from ..ops.transitions import LMLayout, transitions
from .base import CHUNK, ChunkGraph, clone_tree

NEG_INF = -1e30
SHIFT = 1 << 10
#: predecessors per column in the exit guard's top-J bonus tables
GUARD_TOPJ = 8


def _eascr(escore, tf, entv_at_entry, Mcp, t):
    """The segment acoustic score of exits at frames `t` (`adapt_records`'
    eascr): the exit score less the word's entry score, plus the renorm
    offsets subtracted between its entry frame tf-1 and t (Mcp[t] = sum
    of the offsets of frames < t).  Exits with tf = 0 entered at the
    start (no entry score)."""
    has = tf > 0
    tfi = np.clip(tf - 1, 0, len(Mcp) - 2)
    corr = Mcp[t] - np.where(has, Mcp[tfi], 0.0)
    return (escore - np.where(has, entv_at_entry, 0.0) + corr).astype(
        np.float32)


class _Part:
    """One part of a split decoder's word-transition block at one batch
    size B on card `device`: its block tables `tables`, the block's
    seven outputs [B, columns] on its card (`outs`) and on the lead
    (`lead_outs`).  A part on another card than the lead's also has a
    stream of that card (`stream`) and the frame's exits copied there
    (`exits`: kv, ki, ctx_k, fb_k [B, K] and svk [B, NRC, K]), and its
    `lead_outs` are a copy of `outs`; a part on the lead's card reads
    the lead's exits and runs on the lead's stream (those two None), and
    its `lead_outs` are its `outs`."""

    def __init__(self, dec, device, tables, B):
        self.tables = tables
        n = tables["isfill_E"].shape[0]
        self.stream = self.exits = None
        if device == dec.device:
            self.outs = self.lead_outs = transitions_ops.outputs(B, n,
                                                                 device)
            return
        self.stream = torch.cuda.Stream(device)
        K, NRC = dec.K, dec.n_rcp
        # allocated on the part's stream, which alone uses them there
        with torch.cuda.stream(self.stream):
            self.exits = tuple(
                torch.empty(shape, dtype=dt, device=device)
                for shape, dt in (((B, K), torch.float32),
                                  ((B, K), torch.int64),
                                  ((B, K), torch.int32),
                                  ((B, K), torch.int64),
                                  ((B, NRC, K), torch.float32)))
            self.outs = transitions_ops.outputs(B, n, device)
        self.lead_outs = transitions_ops.outputs(B, n, dec.device)


class _SplitBuffers:
    """The static buffers of a split decoder's word-transition block at
    one batch size B: one `_Part` for each part of the "model" group, in
    column order, and the joined outputs [B, E] on the lead (`joined`).
    The eager step and a capture write the same ones (`_transitions`),
    so nothing of the block allocates on a part's card under capture."""

    def __init__(self, dec, B):
        self.tables, self.B = dec.tables, B
        self.parts = [_Part(dec, d, tb, B) for d, tb in dec.tables["columns"]]
        self.joined = transitions_ops.outputs(B, dec.nE, dec.device)


@dataclass
class Seg:
    """One word segment of a hypothesis (frames inclusive)."""
    word: str
    start: int
    end: int


@dataclass
class _Chain:
    """One right-aligned chain bucket: words [w_lo, w_hi) with padded
    depth D (covers first + interior phones; finals live elsewhere for
    real words, in-chain for CI-filler chains)."""

    w_lo: int
    w_hi: int
    D: int
    senid: np.ndarray = None          # [NST, D, Wb] int32
    tp: np.ndarray = None             # [D, Wb, NST, NST+1] f32
    fd: np.ndarray = None             # [Wb] first depth per word
    firstmask: np.ndarray = None      # [D, Wb] bool
    # mpx first-phone variants (real multi-phone words only)
    senid_first: np.ndarray = None    # [NST, RF, Wb] int32
    n_var: np.ndarray = None          # [Wb]
    RF: int = 0

    @property
    def Wb(self):
        return self.w_hi - self.w_lo


class _LazyBatchRecords:
    """List-like view of per-utterance adapted records that copies a
    batch's raw device records to the host only for the utterances a
    consumer indexes."""

    def __init__(self, dec, raw_dev, nf):
        self._dec = dec
        self._raw = raw_dev      # tuple of [B, T, ...] tensors
        self._nf = nf
        self._cache = {}

    def __len__(self):
        return len(self._nf)

    def __getitem__(self, b):
        if b not in self._cache:
            per_utt = tuple(r[b].cpu().numpy() for r in self._raw)
            self._cache[b] = self._dec.adapt_records(
                per_utt, int(self._nf[b]))
        return self._cache[b]

    def __iter__(self):
        return (self[b] for b in range(len(self)))


class NgramFusedDecoder:
    """Exact-trigram full-vocabulary Viterbi with a fused per-frame step."""

    LM_TABLE_BUDGET = None   # default: env PS_LM_TABLE_BYTES or 2 GiB
    #: frames per chunk of the scan and its senone pre-gather
    CHUNK = CHUNK
    #: the scan's `base.ChunkGraph` (None before its first scan)
    chunk_graph = None

    def __init__(self, am: AcousticModel, d2p: Dict2Pid, lm: NgramModel,
                 silprob: float = 0.005, fillprob: float = 1e-8,
                 pip: float = 1.0, nwpen: float = 1.0,
                 topk: int = 96, depth_buckets: tuple = (), device=None,
                 graph: bool = True):
        self.device = resolve_device(device)
        #: replay the scan's captured chunks (default) or, with False,
        #: call them uncaptured (`scan(..., graph=)` overrides it)
        self.graph = graph
        self.am = am
        self.d2p = d2p
        self.dict = d2p.dict
        self.lm = lm
        self.mdef = am.mdef
        ln = lambda p: math.log(p) / UNIT_NATS  # noqa: E731 shifted units
        self.pip = ln(pip)
        self.nwpen = ln(nwpen)
        self.silpen = self.pip + ln(silprob)
        self.fillpen = self.pip + ln(fillprob)
        self.topk = topk
        self.depth_buckets = tuple(depth_buckets)
        self.rebuild()

    #: a "model" group's devices (`shard`), the lead first; None: one
    #: device holds every table
    model_devices = None

    def rebuild(self):
        """Build the network and its host and device tables, again after
        the dictionary or the LM changed (the JAX decoder's `_build`,
        which also drops its compiled scan and device tables)."""
        self._build()
        self.host_tables = self._host_tables()
        self.tables = self.device_tables(self.host_tables, self.device,
                                         self.model_devices)

    def to(self, device, graph=None) -> "NgramFusedDecoder":
        """A decoder sharing this one's host network, with its tables on
        `device` (e.g. to check a CUDA run against the CPU); `graph`
        (default this one's) as the constructor's."""
        other = object.__new__(type(self))
        other.__dict__.update(self.__dict__)
        other.device = torch.device(device)
        if graph is not None:
            other.graph = graph
        other.model_devices = None
        other.tables = self.device_tables(self.host_tables, other.device)
        return other

    def shard(self, devices) -> "NgramFusedDecoder":
        """A decoder sharing this one's host network, split over the
        "model" group `devices` (tensor parallelism; one device may hold
        several parts).  The first device, the lead, holds the carry and
        runs the chain and fan kernels, the top-K sort, the exactness
        guard, the renormalization and the records; the word-transition
        block (the LM row fetch, `cand` and its max over the top-K exits)
        runs on every device of the group over its own contiguous range
        of entry columns (`convert.column_ranges`), and the senone
        scoring over its codebooks or senone slots
        (`convert.split_scoring_tensors`).  Its scan replays CUDA graphs
        that span the group's cards, as the unsplit decoder's does.  The
        records equal the unsplit decoder's bit for bit on the same
        costs; the split costs agree with the unsplit ones within the
        scoring's float32 tolerance."""
        devs = [resolve_device(d) for d in devices]
        other = object.__new__(type(self))
        other.__dict__.update(self.__dict__)
        other.device = devs[0]
        other.model_devices = devs
        other.tables = self.device_tables(self.host_tables, devs[0], devs)
        return other

    def device_tables(self, tables: dict, device, model_devices=None) -> dict:
        """Scan tables on `device` (`convert.scan_tables`) from this
        decoder's `host_tables`, or from the JAX decoder's `_dev_tables`
        as NumPy, which hold the same keys.  The chain buckets' tables
        become one `ops.chain.ChainGroup` (`chain`) with their senone ids
        from `senid_all`, cut by `seg_shapes` (the chain kernel reads
        each node's cost by its id from the frame's cost row); the rest
        of `senid_all` becomes the per-chunk pre-gather's index lists
        (`gather`: name -> (ids, per-utterance shape of the result)):
        the finals' and the single-phone columns'.
        With a "model" group `model_devices` (lead first) the
        word-transition block's tables are split by entry columns
        (`convert.split_scan_tables`): `columns` lists each device's
        (device, block tables); without one it is None and the block
        reads these tables."""
        if model_devices is None:
            out = scan_tables(tables, device)
            out["columns"] = None
        else:
            ranges = column_ranges(
                np.asarray(tables["accept_E"]).shape[0], len(model_devices))
            out, out["columns"] = split_scan_tables(
                tables, device, [(d, e0, e1) for d, (e0, e1)
                                 in zip(model_devices, ranges)])
        sizes = [int(np.prod(s)) for s in self.seg_shapes.values()]
        seg = {name: ids.view(shape) for (name, shape), ids in zip(
            self.seg_shapes.items(),
            torch.split(out.pop("senid_all"), sizes))}
        buckets = [dict(tp=out.pop(f"ch_tp{k}"), fm=out[f"ch_fm{k}"],
                        nv=out.pop(f"ch_nv{k}"), fd_idx=out.pop(f"fd_idx{k}"),
                        senid=seg["pre", k], senid_first_d=seg["prevd", k])
                   for k in range(len(self.chains))]
        # (the CI chains' segments follow the chain buckets' in k)
        buckets += [dict(tp=out.pop(f"ci_tp{k}"), fm=out[f"ci_fm{k}"],
                         senid=seg["pre", len(self.chains) + k])
                    for k in range(len(self.ci_chains))]
        if "tp_fin_rows" in out:
            # the fan kernel's per-word tables, padded like its carry
            pad = padded_width(self.n_multi) - self.n_multi
            out["lp_idx"] = torch.nn.functional.pad(out["lp_idx"], (0, pad))
            out["tp_fin_rows"] = torch.nn.functional.pad(
                out["tp_fin_rows"], (0, pad), value=NEG_INF)
        out["chain"] = ChainGroup(self.NST, buckets)
        out["gather"] = {name: (seg[name].reshape(-1).long(),
                                self.seg_shapes[name])
                         for name in ("fin", "sp") if name in seg}
        return out

    # -- static structure ----------------------------------------------------


    def _select_words(self):
        """Word list identical in membership to ngram_flat._build, but
        reordered [multi (by length) | single-phone | CI chains]."""
        d, lm, mdef = self.dict, self.lm, self.mdef
        sil = mdef.sil
        picked = []                 # (class, sortkey, wid, lm_wid, fill)
        for wid in range(len(d)):
            base = d.basestr(wid)
            lw = lm.wid(base)
            pron = [int(x) for x in d.pron(wid)]
            is_ci = d.is_filler(wid) or (len(pron) == 1 and pron[0] == sil)
            if d.is_filler(wid) and wid not in (d.startwid, d.finishwid):
                picked.append((2, len(pron), wid, -1, True))
            elif lw >= 0:
                cls = 2 if is_ci else (1 if len(pron) == 1 else 0)
                picked.append((cls, len(pron), wid, lw, False))
        picked.sort(key=lambda t: (t[0], t[1], t[2]))
        self.words = [t[2] for t in picked]
        self.lm_wid = np.array([t[3] for t in picked], np.int32)
        self.is_fill = np.array([t[4] for t in picked], bool)
        self.W = len(picked)
        self.widx = {w: i for i, w in enumerate(self.words)}
        self.n_multi = sum(1 for t in picked if t[0] == 0)
        self.n_single = sum(1 for t in picked if t[0] == 1)
        self.n_ci = self.W - self.n_multi - self.n_single

    def _depth_for(self, length_minus: int) -> int:
        for d in self._depth_buckets:
            if length_minus <= d:
                return d
        return length_minus

    def _build(self):
        self._lm_rows = None
        self.lm_mode = None
        d, mdef, d2p = self.dict, self.mdef, self.d2p
        sseq = mdef.sseq
        tmat_tp = self.am.tmat.tp      # [n_tmat, NST, NST+1] uint8
        NST = mdef.n_emit_state
        self.NST = NST
        sil = mdef.sil
        self._select_words()
        W, n_multi, n_single = self.W, self.n_multi, self.n_single
        prons = [[int(x) for x in d.pron(w)] for w in self.words]

        # transition costs of every CI phone's HMM [n_ci, NST, NST+1]
        t = tmat_tp[mdef.phone_tmat[:mdef.n_ciphone]].astype(np.float32)
        tp_ci = np.where(t == 255, NEG_INF, -t).astype(np.float32)

        # resolve depth buckets: empty tuple = automatic (the JAX
        # package's rule, so both build the same network).  Small W: one
        # bucket per class.  Large W: quantile buckets of the length
        # distribution, since a single bucket pads every word to the
        # longest chain (~3x padding at 20k cmudict words).
        self._depth_buckets = self.depth_buckets
        if not self._depth_buckets:
            need = [len(d.pron(w)) - 1 for w in self.words[:n_multi]] \
                + [len(d.pron(w))
                   for w in self.words[n_multi + n_single:]]
            if not need:
                self._depth_buckets = (1,)
            elif n_multi <= 4000:
                self._depth_buckets = (max(need),)
            else:
                qs = np.quantile(np.array(need), [0.4, 0.75, 0.92, 1.0])
                self._depth_buckets = tuple(sorted(
                    {int(q) for q in qs} | {max(need)}))

        # occurring right contexts: word-initial phones + SIL
        rc_set = sorted({p[0] for p in prons} | {sil})
        self.rc_list = np.array(rc_set, np.int32)
        n_rc = len(rc_set)
        self.n_rcp = n_rc
        rc_plane = np.full(mdef.n_ciphone, -1, np.int32)
        rc_plane[rc_set] = np.arange(n_rc)
        self.f0_plane = np.array([rc_plane[p[0]] for p in prons], np.int32)
        self.fb_ci = np.array([p[-1] for p in prons], np.int32)

        # ---- multi-phone words: chain buckets + finals fan ----
        chains: list[_Chain] = []
        lo = 0
        while lo < n_multi:
            D = self._depth_for(len(prons[lo]) - 1)
            hi = lo
            while hi < n_multi and self._depth_for(len(prons[hi]) - 1) == D:
                hi += 1
            chains.append(_Chain(w_lo=lo, w_hi=hi, D=D))
            lo = hi
        lc_cls = np.zeros((n_multi, mdef.n_ciphone), np.int32)
        # the first phone's variant ssids (sorted) and each left
        # context's variant index, per first diphone (p0, p1)
        fvar = {}
        for p in prons[:n_multi]:
            if (p[0], p[1]) not in fvar:
                row = d2p.ldiph_lc[p[0], p[1]]
                uniq = np.unique(row)
                fvar[p[0], p[1]] = (uniq, np.searchsorted(uniq, row))
        for ch in chains:
            Wb, D = ch.Wb, ch.D
            senid = np.zeros((NST, D, Wb), np.int32)
            tp = np.tile(tp_ci[sil][None, None], (D, Wb, 1, 1))
            P = prons[ch.w_lo:ch.w_hi]
            L = np.array([len(p) for p in P])
            Pm = np.full((Wb, L.max()), -1, np.int64)      # padded phones
            for k, p in enumerate(P):
                Pm[k, :len(p)] = p
            fd = D - (L - 1)
            var = [fvar[p[0], p[1]] for p in P]
            nvar = np.array([len(u) for u, _ in var], np.int64)
            RF = int(nvar.max())
            lc_cls[ch.w_lo:ch.w_hi] = np.stack([inv for _, inv in var])
            cols = np.arange(Wb)
            senid[:, fd, cols] = sseq[[int(u[0]) for u, _ in var]].T
            tp[fd, cols] = tp_ci[Pm[:, 0]]
            # interior phones j = 1..L-2 (`Dict2Pid.internal_ssids`)
            for j in range(1, Pm.shape[1] - 1):
                k = np.nonzero(L - 1 > j)[0]
                ss = d2p.internal[Pm[k, j], Pm[k, j - 1], Pm[k, j + 1]]
                senid[:, fd[k] + j, k] = sseq[ss.astype(np.int64)].T
                tp[fd[k] + j, k] = tp_ci[Pm[k, j]]
            # variant v of a word with fewer variants repeats its last
            vi = np.stack([u[np.minimum(np.arange(RF), len(u) - 1)]
                           for u, _ in var]).astype(np.int64)  # [Wb, RF]
            senid_first = np.ascontiguousarray(
                sseq[vi].transpose(2, 1, 0)).astype(np.int32)
            ch.senid, ch.tp, ch.fd = senid, tp, fd
            ch.firstmask = (np.arange(ch.D)[:, None] == fd[None, :])
            ch.senid_first, ch.n_var, ch.RF = senid_first, nvar, RF
            # Shared per-first-diphone variant planes: the variant ssid
            # set is a function of (p0, p1) alone (ldiph_lc[p0][p1],
            # src/dict2pid.c), so the variant costs need only one plane
            # of senone ids per DISTINCT first diphone; expansion to
            # words is a gather by fd_idx in the chain kernel.
            bpairs = [(prons[ch.w_lo + k][0], prons[ch.w_lo + k][1])
                      for k in range(Wb)]
            fd_list = sorted(set(bpairs))
            fd_of = {p: i for i, p in enumerate(fd_list)}
            n_fd = len(fd_list)
            senid_first_d = np.zeros((NST, RF, n_fd), np.int32)
            for fi, (a, b) in enumerate(fd_list):
                u = np.unique(d2p.ldiph_lc[a, b])
                for v in range(RF):
                    senid_first_d[:, v, fi] = \
                        sseq[int(u[min(v, len(u) - 1)])]
            ch.senid_first_d = senid_first_d
            ch.fd_idx = np.array([fd_of[p_] for p_ in bpairs], np.int32)
        self.chains = chains
        self.lc_cls = lc_cls

        # finals fan [3, n_rc, n_multi]
        senid_fin = np.zeros((NST, n_rc, max(n_multi, 1)), np.int32)
        tp_fin = np.tile(tp_ci[sil][None], (max(n_multi, 1), 1, 1))
        if n_multi:
            last = np.array([p[-1] for p in prons[:n_multi]])
            pen = np.array([p[-2] for p in prons[:n_multi]])
            ss = d2p.rdiph_rc[last, pen][:, rc_set]            # [Wm, n_rc]
            senid_fin[:, :, :n_multi] = sseq[ss.astype(np.int64)].transpose(
                2, 1, 0)
            tp_fin[:n_multi] = tp_ci[last]
        self.senid_fin, self.tp_fin = senid_fin, tp_fin
        # shared per-final-diphone fan planes (rdiph_rc[last, penult] is
        # a function of the final diphone alone; same sharing trick as
        # senid_first_d above)
        lp_pairs = [(prons[k][-1], prons[k][-2]) for k in range(n_multi)]
        lp_list = sorted(set(lp_pairs))
        lp_of = {p: i for i, p in enumerate(lp_list)}
        n_lp = max(len(lp_list), 1)
        senid_fin_d = np.zeros((NST, n_rc, n_lp), np.int32)
        for li_, (a, b) in enumerate(lp_list):
            ss = d2p.rdiph_rc[a, b][rc_set]
            senid_fin_d[:, :, li_] = sseq[ss.astype(np.int64)].T
        self.senid_fin_d = senid_fin_d
        # per-word final-diphone index (the fan kernel's expansion)
        self.lp_idx = np.array([lp_of[p_] for p_ in lp_pairs],
                               np.int32) if n_multi else \
            np.zeros(0, np.int32)

        # ---- single-phone real words: explicit (lc-class) columns ----
        # Rectangular layout: every single word owns exactly Cmax
        # columns (dead pad columns accept no left context and stay at
        # NEG_INF), so the per-word exit reduction in the scan is ONE
        # vectorized [Cmax, n_single] argmax instead of a Python loop of
        # per-word reductions (kernel-count, see _depth_buckets note).
        word_variants = []    # (word index, uniq ssid-rows, inv)
        Cmax = 1
        for k in range(n_multi, n_multi + n_single):
            p0 = prons[k][0]
            table = d2p.lrdiph_rc[p0]
            uniq, inv = np.unique(table, axis=0, return_inverse=True)
            word_variants.append((k, uniq, inv))
            Cmax = max(Cmax, len(uniq))
        sp_cols = []          # (word index, variant, rep lc, live)
        accept_sp = []        # [n_ci] bool per column
        for k, uniq, inv in word_variants:
            for v in range(Cmax):
                if v < len(uniq):
                    rep = int(np.nonzero(inv == v)[0][0])
                    sp_cols.append((k, v, rep))
                    accept_sp.append(inv == v)
                else:
                    sp_cols.append((k, 0, int(np.nonzero(inv == 0)[0][0])))
                    accept_sp.append(np.zeros(mdef.n_ciphone, bool))
        SP = len(sp_cols)
        self.SP = SP
        self.sp_cmax = Cmax
        senid_sp = np.zeros((NST, n_rc, max(SP, 1)), np.int32)
        tp_sp = np.tile(tp_ci[sil][None], (max(SP, 1), 1, 1))
        col_word = np.zeros(max(SP, 1), np.int64)
        for c, (k, v, rep) in enumerate(sp_cols):
            p0 = prons[k][0]
            ss = d2p.lrdiph_rc[p0, rep][rc_set]
            senid_sp[:, :, c] = sseq[ss.astype(np.int64)].T
            tp_sp[c] = tp_ci[p0]
            col_word[c] = k
        self.senid_sp, self.tp_sp, self.sp_col_word = senid_sp, tp_sp, col_word
        self.accept_sp = (np.stack(accept_sp)
                          if SP else np.zeros((0, mdef.n_ciphone), bool))
        # column ranges per single word (rectangular: width Cmax each)
        self.sp_ranges = [(n_multi + i, i * Cmax, (i + 1) * Cmax)
                          for i in range(n_single)]

        # ---- CI chains (fillers, <s>, </s>) ----
        ci0 = n_multi + n_single
        ci_chains: list[_Chain] = []
        lo = ci0
        while lo < W:
            D = self._depth_for(len(prons[lo]))
            hi = lo
            while hi < W and self._depth_for(len(prons[hi])) == D:
                hi += 1
            ci_chains.append(_Chain(w_lo=lo, w_hi=hi, D=D))
            lo = hi
        for ch in ci_chains:
            Wb, D = ch.Wb, ch.D
            senid = np.zeros((NST, D, Wb), np.int32)
            tp = np.tile(tp_ci[sil][None, None], (D, Wb, 1, 1))
            fd = np.zeros(Wb, np.int64)
            for k in range(Wb):
                pron = prons[ch.w_lo + k]
                L = len(pron)
                fd[k] = D - L
                for j, ci in enumerate(pron):
                    senid[:, fd[k] + j, k] = sseq[int(mdef.phone_ssid[ci])]
                    tp[fd[k] + j, k] = tp_ci[ci]
            ch.senid, ch.tp, ch.fd = senid, tp, fd
            ch.firstmask = (np.arange(D)[:, None] == fd[None, :])
        self.ci_chains = ci_chains

        # ---- entry-target axis E = [multi | single cols | ci words] ----
        nE = n_multi + SP + self.n_ci
        self.nE = nE
        e2w = np.concatenate([
            np.arange(n_multi, dtype=np.int64),
            col_word[:SP],
            np.arange(ci0, W, dtype=np.int64)])
        self.e2w = e2w
        self.isfill_E = self.is_fill[e2w]
        self.f0p_E = self.f0_plane[e2w]
        fillpen_w = np.where(
            np.array([self.words[i] == d.silwid for i in range(W)]),
            self.silpen, self.fillpen).astype(np.float32)
        self.fillpen_E = fillpen_w[e2w]
        # accept matrix: 1 everywhere except single columns (lc class)
        acc = np.ones((nE, mdef.n_ciphone), np.float32)
        if SP:
            acc[n_multi:n_multi + SP] = self.accept_sp.astype(np.float32)
        self.accept_E = acc
        self.lmwid_E = np.where(self.lm_wid[e2w] >= 0,
                                self.lm_wid[e2w], 0).astype(np.int64)

        # per-word static exit-target index (E index of the word's
        # chain/fan; singles are resolved at runtime to the winning col)
        etgt0 = np.zeros(W, np.int64)
        etgt0[:n_multi] = np.arange(n_multi)
        for k, c0, c1 in self.sp_ranges:
            etgt0[k] = n_multi + c0
        etgt0[ci0:] = n_multi + SP + np.arange(W - ci0)
        self.etgt0 = etgt0

        self.col_lm = np.where(self.lm_wid >= 0, self.lm_wid, 0)
        self.V = self.lm.counts[0]
        self.start_idx = (self.widx.get(d.startwid)
                          if d.startwid in self.widx else None)
        self.finish_idx = (self.widx.get(d.finishwid)
                           if d.finishwid in self.widx else None)
        # diagnostics: padded node count of the dense network
        self.P = int(sum(ch.D * ch.Wb for ch in chains + ci_chains)
                     + n_rc * (n_multi + SP))

    # -- LM tables -----------------------------------------------------------

    def _lm_tables(self):
        """(rows [R, E] f32, ctx_next [V+1, E] f32, ctx2h1 [R] i32).

        rows[r, e] = exact weighted Katz score of entry target e's word
        under history class r (r = 0 empty, 1+h unigram context h,
        1+V+b bigram-entry context b; lm/ngram.py dense_context_rows).
        ctx_next[h1, e] = context row carried after entering e's word
        with previous real word h1.  ctx2h1[r] = newest history word of
        class r (V for the empty class)."""
        if getattr(self, "lm_mode", None) is not None:
            return (self._lm_rows, self._ctx_next, self._ctx2h1,
                    self._ctx2h2)
        lm, V = self.lm, self.V
        budget = self.LM_TABLE_BUDGET
        if budget is None:
            budget = int(os.environ.get("PS_LM_TABLE_BYTES", 2 << 30))
        cols_E = self.col_lm[self.e2w]
        n_bg = lm.counts[1] if lm.order >= 2 else 0
        R = 1 + V + n_bg
        # Exactness bound: LM context ids (1+V+n_bg), word ids and entry
        # targets ride as f32 payload columns / one-hot matmul payloads
        # in the scan, which is exact only for integers < 2^24.  Refuse
        # loudly rather than silently corrupt contexts/backtraces.
        if R >= (1 << 24) or self.nE >= (1 << 24):
            raise ValueError(
                f"LM too large for the fused scan's f32 payload channels:"
                f" 1+V+n_bigrams={R}, E={self.nE} must be < 2^24 for"
                f" exact f32 integer arithmetic (ngram_fused payload"
                f" matmuls). Use a smaller LM or shard the model.")
        force = os.environ.get("PS_LM_MODE")
        sparse_budget = int(os.environ.get("PS_LM_SPARSE_BYTES", 6 << 30))
        if force == "rows":
            pass
        elif force == "csr" or (force != "sparse"
                                and lm.order >= 3 and n_bg
                                and R * self.nE * 4 > budget
                                and 2 * (V + 1) * self.nE * 4
                                > sparse_budget):
            # mode C (reference scale): fully sparse, since even mode B's
            # dense [V+1, E] bigram and context tables are O(V*E)
            return self._lm_tables_csr(cols_E)
        if lm.order < 3 or n_bg == 0 or (
                force != "sparse" and R * self.nE * 4 <= budget):
            # mode A: one dense successor row per history class
            self.lm_mode = "rows"
            rows, with_tri = lm.dense_context_rows(cols_E, budget)
            rows = rows / SHIFT
            rows[:, self.isfill_E] = 0.0
            self.lm_order_used = 3 if with_tri else \
                (2 if lm.order >= 2 else 1)
            R = rows.shape[0]
        else:
            # mode B (scale): dense bigram rows [V+1, E] + sparse
            # per-context trigram overrides -- exact trigram at
            # O(V*E) memory instead of O((V+n_bigrams)*E)
            self.lm_mode = "sparse"
            rows = None
            bg = lm.bigram_rows_dense(cols_E) / SHIFT
            bg[:, self.isfill_E] = 0.0
            tgc_next, tg_cols, tg_vals, bo2w = \
                lm.trigram_corrections(cols_E)
            S_max = int(np.max(tgc_next[1:] - tgc_next[:-1])) \
                if n_bg else 0
            self._lm_sparse = dict(
                bg=bg, tgc_next=tgc_next.astype(np.int32),
                tg_cols=np.concatenate(
                    [tg_cols, np.zeros(S_max, np.int32)]),
                tg_vals=np.concatenate(
                    [tg_vals / SHIFT, np.zeros(S_max, np.float32)]),
                bo2w=bo2w / SHIFT, S_max=S_max, n_bg=n_bg)
            self.lm_order_used = 3 if len(tg_cols) else 2
            with_tri = n_bg > 0
        ctx_next = np.empty((V + 1, self.nE), dtype=np.float32)
        ctx_next[:, :] = (1 + cols_E)[None, :].astype(np.float32)
        ctx2h1 = np.full(R, V, np.int32)
        ctx2h1[1:1 + V] = np.arange(V)
        ctx2h2 = np.full(R, V, np.int32)
        if with_tri:
            ho, hn = lm.bigram_entries()
            ctx2h1[1 + V:] = hn
            ctx2h2[1 + V:] = ho
            # vectorized scatter of trigram-context successors (no
            # per-bigram Python loop)
            real_cols = np.nonzero(~self.isfill_E)[0]
            key = cols_E[real_cols]
            order = np.argsort(key, kind="stable")
            skey = key[order]
            beg = np.searchsorted(skey, hn)
            end = np.searchsorted(skey, hn, side="right")
            cnt = end - beg
            if cnt.sum():
                r_idx = np.repeat(ho, cnt)
                v_idx = np.repeat(1 + V + np.arange(len(ho)), cnt)
                base = np.repeat(beg, cnt)
                within = (np.arange(cnt.sum())
                          - np.repeat(np.cumsum(cnt) - cnt, cnt))
                c_idx = real_cols[order[base + within]]
                ctx_next[r_idx, c_idx] = v_idx.astype(np.float32)
        self._lm_rows, self._ctx_next = rows, ctx_next
        self._ctx2h1, self._ctx2h2 = ctx2h1, ctx2h2
        return rows, ctx_next, ctx2h1, ctx2h2

    FAT_CAP = 1024       # CSR rows longer than this densify ("fat" rows)

    def _lm_tables_csr(self, cols_E):
        """Mode C host tables (the JAX `_lm_tables_csr`): per entry column
        e the base successor score under history h is uni_row[e] +
        bo1w[h]; explicit bigrams and successor contexts overlay it
        through per-history CSR slices (umeta: start, length, bo1w bits,
        fat index); histories whose row exceeds FAT_CAP (<s>) get dense
        "fat" rows instead.  Trigram corrections and per-context metadata
        are mode B's."""
        lm, V = self.lm, self.V
        n_bg = lm.counts[1]
        self.lm_mode = "csr"
        uni = (lm.lv_prob[0][:V].astype(np.float64) * lm.lw
               + lm.log_wip).astype(np.float32)
        bo1w = np.zeros(V + 1, np.float32)
        bo1w[:V] = lm.lv_bo[0][:V].astype(np.float64) * lm.lw
        uni_row = uni[cols_E] / SHIFT
        uni_row[self.isfill_E] = 0.0
        bo1w = bo1w / SHIFT
        bg_next, bg_cols, bg_vals, bg_ctx = lm.bigram_csr(
            cols_E, skip=self.isfill_E)
        bg_vals = bg_vals / SHIFT
        rlen = bg_next[1:] - bg_next[:-1]                 # [V+1]
        fat_hs = np.nonzero(rlen > self.FAT_CAP)[0]
        n_fat = len(fat_hs)
        fat_rows = np.zeros((max(n_fat, 1), self.nE), np.float32)
        fat_ctx = np.zeros((max(n_fat, 1), self.nE), np.float32)
        ctx_base = (1 + cols_E).astype(np.float32)
        for i, h in enumerate(fat_hs):
            lo, hi = int(bg_next[h]), int(bg_next[h + 1])
            fat_rows[i] = uni_row + bo1w[h]
            fat_rows[i, bg_cols[lo:hi]] = bg_vals[lo:hi]
            fat_ctx[i] = ctx_base
            fat_ctx[i, bg_cols[lo:hi]] = bg_ctx[lo:hi]
        fat_of = np.full(V + 1, -1, np.int32)
        fat_of[fat_hs] = np.arange(n_fat)
        # non-fat rows padded to SB for the step's fixed-width slices;
        # fat rows start at 0 with length 0
        kept = rlen[rlen <= self.FAT_CAP]
        SB = int(kept.max()) if len(kept) else 0
        keepmask = np.repeat(rlen <= self.FAT_CAP, rlen)
        rlen_k = np.where(rlen <= self.FAT_CAP, rlen, 0)
        umeta = np.zeros((V + 1, 4), np.int32)
        umeta[:, 0] = np.concatenate([[0], np.cumsum(rlen_k)[:-1]])
        umeta[:, 1] = rlen_k
        umeta[:, 2] = bo1w.astype(np.float32).view(np.int32)
        umeta[:, 3] = fat_of
        tgc_next, tg_cols, tg_vals, bo2w = lm.trigram_corrections(cols_E)
        S_max = int(np.max(tgc_next[1:] - tgc_next[:-1])) if n_bg else 0
        pad = lambda x, n, dt: np.concatenate([x, np.zeros(n, dt)])  # noqa: E731
        self._lm_sparse = dict(
            csr=True, uni_row=uni_row, umeta=umeta,
            bg_cols=pad(bg_cols[keepmask], SB, np.int32),
            bg_vals=pad(bg_vals[keepmask], SB, np.float32),
            bg_ctx=pad(bg_ctx[keepmask], SB, np.float32),
            SB=SB, fat_rows=fat_rows, fat_ctx=fat_ctx, n_fat=n_fat,
            ctx_base=ctx_base, tgc_next=tgc_next.astype(np.int32),
            tg_cols=pad(tg_cols, S_max, np.int32),
            tg_vals=pad(tg_vals / SHIFT, S_max, np.float32),
            bo2w=bo2w / SHIFT, S_max=S_max, n_bg=n_bg)
        self.lm_order_used = 3 if len(tg_cols) else 2
        ho, hn = lm.bigram_entries()
        ctx2h1 = np.full(1 + V + n_bg, V, np.int32)
        ctx2h1[1:1 + V] = np.arange(V)
        ctx2h1[1 + V:] = hn
        ctx2h2 = np.full(1 + V + n_bg, V, np.int32)
        ctx2h2[1 + V:] = ho
        self._lm_rows, self._ctx_next = None, None
        self._ctx2h1, self._ctx2h2 = ctx2h1, ctx2h2
        return None, None, ctx2h1, ctx2h2

    # -- guard tables --------------------------------------------------------

    def _guard_tables(self, rows_np, ctx2h1, maxb_np, J):
        """Per-column top-J predecessor-bonus tables for the tightened
        top-K exactness guard (see _make_scan).  BMAX[h, e] bounds the
        successor score into column e of ANY context whose newest word
        is h; a real word's exit context always has h = that word
        (erw1 assignment in the scan), so excluded real exits are
        bounded by their own live exit score + BMAX[w].  Returns
        (gw [J, E] word-axis ids, gval [J, E], grest [E] floor for all
        other words + the empty-history class, fill_w word-axis filler
        ids) or None when the mode/size doesn't support it."""
        V, E, W = self.V, self.nE, self.W
        if self.lm_mode == "rows":
            R = rows_np.shape[0]
            BMAX = np.full((V + 1, E), -1e30, np.float32)
            np.maximum.at(BMAX, np.minimum(ctx2h1[:R], V), rows_np)
            empty_row = BMAX[V].copy()
        elif self.lm_mode == "sparse":
            sp = self._lm_sparse
            bg = sp["bg"]                               # [V+1, E]
            n_bg = sp["n_bg"]
            addv = np.zeros(V + 1, np.float32)
            if n_bg:
                ho, hn = self.lm.bigram_entries()
                np.maximum.at(addv, hn, sp["bo2w"].astype(np.float32))
            BMAX = bg + addv[:, None]
            if n_bg:
                tgcn = sp["tgc_next"].astype(np.int64)
                n_tg = int(tgcn[-1])
                if n_tg:
                    h1_rep = np.repeat(hn, tgcn[1:] - tgcn[:-1])
                    np.maximum.at(
                        BMAX, (h1_rep, sp["tg_cols"][:n_tg]),
                        sp["tg_vals"][:n_tg])
            empty_row = BMAX[V].copy()
        else:
            return None                                 # mode C: fallback
        self._guard_bmax = BMAX                         # [V+1, E] f32
        cand = BMAX[np.minimum(self.col_lm, V)]         # [W, E]
        cand[self.is_fill] = -np.inf
        cand[self.lm_wid < 0] = -np.inf
        Jc = min(J, max(int((~self.is_fill).sum()) - 1, 1))
        part = np.argpartition(-cand, Jc, axis=0)[:Jc + 1]   # [J+1, E]
        vals = np.take_along_axis(cand, part, axis=0)
        order = np.argsort(-vals, axis=0, kind="stable")
        part = np.take_along_axis(part, order, axis=0)
        vals = np.take_along_axis(vals, order, axis=0)
        gw = part[:Jc].astype(np.int32)
        gval = np.nan_to_num(vals[:Jc], neginf=-1e30).astype(np.float32)
        grest = np.maximum(
            np.nan_to_num(vals[Jc], neginf=-1e30), empty_row
        ).astype(np.float32)
        fillw = np.nonzero(self.is_fill)[0].astype(np.int32)
        return gw, gval, grest, fillw

    # -- scan tables (host) --------------------------------------------------

    def _host_tables(self) -> dict:
        """NumPy tables of the scan: the JAX `_make_scan` table assembly
        with every key it shares equal to the JAX `_dev_tables`, except
        that one-hot expansion tables are kept as indices (`fd_idx{b}`
        for `fd_oh{b}`, `lp_idx` for `lp_oh`, `f0p_E` for `f0_onehot`)
        and the finals' transitions take the fan step's layout
        (`tp_fin_rows` [NST (NST+1), W] for `tp_fin` [W, NST, NST+1]).
        Also fixes the scan's static layout (K, LM mode, senone
        segments)."""
        NST = self.NST
        W, n_multi, SP = self.W, self.n_multi, self.SP
        n_rc = self.n_rcp
        self.K = K = min(self.topk, W)
        rows_np, ctxn_np, ctx2h1_np, ctx2h2_np = self._lm_tables()
        mode_rows = self.lm_mode == "rows"
        mode_csr = self.lm_mode == "csr"
        tabs = {} if mode_csr else {"ctx_next": ctxn_np}
        self.S_TRI = self.N_BG = self.SB = self.N_FAT = 0
        if mode_rows:
            # rows + [h1, h2] as two appended f32 columns (exact < 2^24)
            tabs["rows"] = np.concatenate(
                [rows_np, ctx2h1_np[:, None].astype(np.float32),
                 ctx2h2_np[:, None].astype(np.float32)], axis=1)
        else:
            sp = self._lm_sparse
            self.S_TRI = S_TRI = sp["S_max"]
            self.N_BG = N_BG = sp["n_bg"]
            tg2d_budget = int(os.environ.get("PS_TG2D_BYTES", 1 << 30))
            if S_TRI and N_BG and N_BG * S_TRI * 8 <= tg2d_budget:
                tgcn = sp["tgc_next"].astype(np.int64)
                n_tg = int(tgcn[-1])
                cnts = tgcn[1:] - tgcn[:-1]
                rows_i = np.repeat(np.arange(N_BG), cnts)
                within = np.arange(n_tg) - np.repeat(tgcn[:-1], cnts)
                tg2c = np.zeros((N_BG, S_TRI), np.int32)
                tg2v = np.zeros((N_BG, S_TRI), np.float32)
                tg2c[rows_i, within] = sp["tg_cols"][:n_tg]
                tg2v[rows_i, within] = sp["tg_vals"][:n_tg]
                tabs["tg2c"] = tg2c
                tabs["tg2v"] = tg2v
            else:
                tabs["tg_cols"] = sp["tg_cols"]
                tabs["tg_vals"] = sp["tg_vals"]
            if mode_csr:
                for k in ("uni_row", "umeta", "fat_rows", "fat_ctx",
                          "ctx_base", "bg_cols", "bg_vals", "bg_ctx"):
                    tabs[k] = sp[k]
                self.SB, self.N_FAT = sp["SB"], sp["n_fat"]
            else:
                tabs["bg"] = sp["bg"]                      # [V+1, E] f32
            # per-bigram-context metadata rows [n_bg, 8] i32:
            # (h1, h2, bo2w bits, tgc_start, tgc_count, pad...)
            bgmeta = np.zeros((max(N_BG, 1), 8), np.int32)
            if N_BG:
                tgcn = sp["tgc_next"].astype(np.int64)
                bgmeta[:, 0] = ctx2h1_np[1 + self.V:]
                bgmeta[:, 1] = ctx2h2_np[1 + self.V:]
                bgmeta[:, 2] = sp["bo2w"].astype(np.float32).view(np.int32)
                bgmeta[:, 3] = tgcn[:-1]
                bgmeta[:, 4] = (tgcn[1:] - tgcn[:-1])
            tabs["bgmeta"] = bgmeta
        # top-K guard bound: maxb[e] = max over every LM context of column
        # e's weighted successor score (see the JAX _make_scan)
        if mode_rows:
            maxb_np = rows_np[:, :self.nE].max(axis=0)
        else:
            sp_ = self._lm_sparse
            if mode_csr:
                bo1w_all = sp_["umeta"][:, 2].view(np.float32).astype(
                    np.float64)
                maxb_np = sp_["uni_row"].astype(np.float64) \
                    + float(bo1w_all.max())
                nbgx = len(sp_["bg_cols"]) - sp_["SB"]
                if nbgx:
                    bgmx = np.full(self.nE, -np.inf)
                    np.maximum.at(bgmx, sp_["bg_cols"][:nbgx],
                                  sp_["bg_vals"][:nbgx].astype(np.float64))
                    maxb_np = np.maximum(maxb_np, bgmx)
                if sp_["n_fat"]:
                    maxb_np = np.maximum(maxb_np,
                                         sp_["fat_rows"].max(axis=0))
            else:
                maxb_np = sp_["bg"].max(axis=0).astype(np.float64)
            if sp_["n_bg"]:
                maxb_np = maxb_np + max(float(sp_["bo2w"].max()), 0.0)
                n_tg = int(sp_["tgc_next"][-1])
                if n_tg:
                    tgmax = np.full(self.nE, -np.inf)
                    np.maximum.at(tgmax, sp_["tg_cols"][:n_tg],
                                  sp_["tg_vals"][:n_tg].astype(np.float64))
                    maxb_np = np.maximum(maxb_np, tgmax)
        # tightened per-predecessor guard (default; mode C falls back to
        # the global bound above)
        guard_budget = int(os.environ.get("PS_GUARD_BYTES", 3 << 30))
        GJ = GUARD_TOPJ
        guard_np = None
        self.GM = 0
        if K < W and GJ > 0 and self.W * self.nE * 4 <= guard_budget:
            guard_np = self._guard_tables(rows_np, ctx2h1_np, maxb_np, GJ)
        if guard_np is not None:
            gw_t, gv_t, grest_t, fillw_t = guard_np
            tabs["guard_w"] = gw_t                    # [J, E] i32
            tabs["guard_v"] = gv_t                    # [J, E] f32
            tabs["guard_rest"] = grest_t              # [E] f32
            tabs["guard_fillw"] = fillw_t             # [n_fill] i32
            tabs["guard_wf"] = (
                self.f0p_E[None, :].astype(np.int64) * W
                + gw_t.astype(np.int64)).astype(np.int32)
            # dynamic-rank refinement (opt-in, PS_GUARD_TOPM=64): the
            # exits ranked K..K+GM get their exact per-word bonus row of
            # the [V+1, E] BMAX table, and the rest-floor drops to
            # kv[K+GM-1]; only the guard count changes
            GM = int(os.environ.get("PS_GUARD_TOPM", "0"))
            bmax_budget = int(os.environ.get("PS_GUARD_BMAX_BYTES", 2 << 30))
            bmax = self._guard_bmax
            if GM > 0 and bmax.nbytes <= bmax_budget and K + GM < W:
                self.GM = GM
                tabs["guard_bmax"] = bmax.astype(np.float32, copy=False)
                tabs["col_lm_W"] = np.minimum(self.col_lm, self.V).astype(
                    np.int32)
                tabs["isfill_W"] = self.is_fill
            self._guard_bmax = None                   # free the host copy
            if len(fillw_t):
                tabs["guard_fillwf"] = (
                    self.f0p_E[None, :].astype(np.int64) * W
                    + fillw_t[:, None].astype(np.int64)).astype(np.int32)
        tabs["f0p_E"] = self.f0p_E.astype(np.int32)
        tabs["maxb_E"] = maxb_np.astype(np.float32)
        tabs["accept_E"] = self.accept_E                 # [E, n_ciph]
        tabs["isfill_E"] = self.isfill_E
        tabs["fillpen_E"] = self.fillpen_E
        tabs["lmwid_E"] = self.lmwid_E.astype(np.float32)
        tabs["isreal_E"] = ~self.isfill_E
        tabs["lc_cls_T"] = self.lc_cls.T.astype(np.int32).copy()
        tabs["etgt0"] = self.etgt0.astype(np.int32)
        tabs["fb_ci"] = self.fb_ci.astype(np.float32)

        # flat senone-id list in named segments, in the JAX package's
        # order (`device_tables` gives the chain segments to the
        # ChainGroup and the rest to the pre-gather): the nodes of chain
        # bucket k ("pre", k), their first-diphone variant planes ("prevd", k),
        # the finals fan, the single-phone columns, the nodes of the CI
        # chains (their k follows the chain buckets', as in the ChainGroup)
        segs = {}
        for k, ch in enumerate(self.chains):
            segs["pre", k] = ch.senid
        for k, ch in enumerate(self.chains):
            segs["prevd", k] = ch.senid_first_d
        if n_multi:
            segs["fin"] = self.senid_fin_d
        if SP:
            segs["sp"] = self.senid_sp[:, :, :SP]
        for k, ch in enumerate(self.ci_chains, len(self.chains)):
            segs["pre", k] = ch.senid
        tabs["senid_all"] = (
            np.concatenate([a.reshape(-1) for a in segs.values()]) if segs
            else np.zeros(0, int)).astype(np.int32)
        self.seg_shapes = {name: a.shape for name, a in segs.items()}

        for bi, ch in enumerate(self.chains):
            tabs[f"fd_idx{bi}"] = ch.fd_idx
            tabs[f"ch_tp{bi}"] = ch.tp
            tabs[f"ch_fm{bi}"] = ch.firstmask
            tabs[f"ch_nv{bi}"] = ch.n_var.astype(np.int32)
        for bi, ch in enumerate(self.ci_chains):
            tabs[f"ci_tp{bi}"] = ch.tp
            tabs[f"ci_fm{bi}"] = ch.firstmask
        if n_multi:
            tabs["lp_idx"] = self.lp_idx
            tabs["tp_fin_rows"] = np.ascontiguousarray(
                self.tp_fin[:n_multi].transpose(1, 2, 0).reshape(
                    NST * (NST + 1), n_multi))
        if SP:
            tabs["tp_sp"] = self.tp_sp[:SP]
        return tabs

    # -- the scan (device) ---------------------------------------------------

    def init_carry(self, B: int) -> dict:
        """The scan carry for B utterances at frame 0: every token dead
        except <s> entered at its first node (JAX `init_carry`).  The
        fan carry is padded to the fan step's width
        (`fan.padded_width`).  The chain carry is flat; `_chain_views`
        gives its buckets."""
        dev, NST, n_rc = self.device, self.NST, self.n_rcp

        def planes(*shape):
            return dict(
                S=torch.full((B, NST) + shape, NEG_INF, dtype=torch.float32,
                             device=dev),
                TF=torch.zeros((B, NST) + shape, dtype=torch.int32,
                               device=dev),
                CTX=torch.zeros((B, NST) + shape, dtype=torch.int32,
                                device=dev))

        c = {"chain": self.tables["chain"].init_carry(B)}
        c["fin"] = (planes(n_rc, padded_width(self.n_multi)) if self.n_multi
                    else None)
        c["sp"] = planes(n_rc, self.SP) if self.SP else None
        # the renormalization not yet subtracted from the chain and fan S
        c["m_prev"] = torch.zeros(B, dtype=torch.float32, device=dev)
        self._enter_start(c)
        return c

    def _enter_start(self, c):
        """<s> entered at its first node of carry `c` (in place)."""
        if self.start_idx is not None:
            s_lm = self.lm.wid("<s>")
            ci = self._chain_views(c["chain"], c["m_prev"].shape[0])[1]
            for bi, ch in enumerate(self.ci_chains):
                if ch.w_lo <= self.start_idx < ch.w_hi:
                    k = self.start_idx - ch.w_lo
                    dep = int(ch.fd[k])
                    ci[bi]["S"][:, 0, dep, k] = 0.0
                    if s_lm >= 0:
                        ci[bi]["CTX"][:, 0, dep, k] = 1 + s_lm

    @staticmethod
    def _carry_fields(c):
        """(name, tensor) of every field of carry `c`: the flat chain
        fields, then the fan's and the single-phone columns', then the
        pending renormalization."""
        out = list(c["chain"].items())
        for name in ("fin", "sp"):
            if c[name] is not None:
                out += list(c[name].items())
        return out + [("m_prev", c["m_prev"])]

    def _reset_carry(self, c):
        """Carry `c` set to `init_carry`'s values, in place."""
        for key, x in self._carry_fields(c):
            x.fill_(NEG_INF if key == "S" else 0)
        self._enter_start(c)

    def _fold_renorm(self, c, B):
        """The pending renormalization of the B-utterance carry `c`
        subtracted from the scores that defer it (the chain and fan
        carries), in place, and reset to 0: one pass, for a carry that
        leaves the scan."""
        m = c["m_prev"][:, None, None, None]
        for v in self.tables["chain"].planes(c["chain"]["S"], B):
            v.sub_(m)
        if c["fin"] is not None:
            c["fin"]["S"].sub_(m)
        c["m_prev"] = torch.zeros_like(c["m_prev"])
        profile.count("scan.renorm_passes")

    def _chain_views(self, flat, B):
        """Per-bucket views of the flat chain carry `flat` (S/TF/CTX/VAR):
        ([dict(S, TF, CTX, VAR) per chain bucket], [dict(S, TF, CTX) per
        CI bucket])."""
        grp = self.tables["chain"]
        views = [dict(S=s, TF=tf, CTX=cx) for s, tf, cx in zip(
            grp.planes(flat["S"], B), grp.planes(flat["TF"], B),
            grp.planes(flat["CTX"], B))]
        n_ch = len(self.chains)
        for e, v in zip(views[:n_ch], grp.var_planes(flat["VAR"], B)):
            e["VAR"] = v
        return views[:n_ch], views[n_ch:]

    def _mask_carry(self, new, old, valid):
        """`new` where `valid` [B], else `old`, for every carry field (the
        pending renormalization too, which goes with its scores).  The
        flat chain fields are not batch-major (the buckets' [B, ...]
        blocks lie end to end), so they are masked through their
        per-bucket views, in place on the step's fresh buffers."""
        B = valid.shape[0]
        grp = self.tables["chain"]
        for key in ("S", "TF", "CTX", "VAR"):
            views = grp.var_planes if key == "VAR" else grp.planes
            for nv, ov in zip(views(new["chain"][key], B),
                              views(old["chain"][key], B)):
                m = valid.view((B,) + (1,) * (nv.dim() - 1))
                nv.copy_(torch.where(m, nv, ov))
        for name in ("fin", "sp"):
            if new[name] is not None:
                m = valid.view(B, 1, 1, 1)
                new[name] = {k: torch.where(m, v, old[name][k])
                             for k, v in new[name].items()}
        new["m_prev"] = torch.where(valid, new["m_prev"], old["m_prev"])
        return new

    def _transitions(self, kv, ki, ctx_k, fb_k, svk, wpen):
        """The word-transition block over every entry column: (entry, am,
        prw_e, ctx_new, erw1, erw2, fb_e) [B, E] on the lead from this
        frame's top-K exits (scores kv, word ids ki, contexts ctx_k,
        final base phones fb_k [B, K], right-context exit planes svk
        [B, n_rc, K]).  On a "model" group each part computes its own
        column range (`_columns`) into its static outputs
        (`_SplitBuffers`), and the lead joins the ranges in column order
        into the joined buffers, which it returns (the next frame
        overwrites them): the max and first argmax over K are per
        column, so the joined tensors are the unsplit block's bit for
        bit.

        A part on another card runs on a stream of its card: it waits for
        the lead's stream (the exits are ready), copies the exits into
        its buffers, runs its block and copies its outputs back to the
        lead, and the lead's stream waits for it.  Those parts are issued
        first, and their copies back last, so that the parts' blocks run
        side by side and beside the lead's own parts.  Only events order
        the streams: the same calls run eagerly and under a capture on
        the lead, whose graph then takes in every card's part."""
        if self.tables["columns"] is None:
            return self._columns(self.tables, kv, ki, ctx_k, fb_k, svk, wpen)
        buf = self._split_buffers(kv.shape[0])
        exits = (kv, ki, ctx_k, fb_k, svk)
        lead = torch.cuda.current_stream(kv.device) if kv.is_cuda else None
        away = [p for p in buf.parts if p.stream is not None]
        for p in away:
            p.stream.wait_stream(lead)
            with torch.cuda.stream(p.stream):
                for b, x in zip(p.exits, exits):
                    b.copy_(x)
                self._columns(p.tables, *p.exits, wpen, out=p.outs)
        for p in buf.parts:
            if p.stream is None:
                self._columns(p.tables, *exits, wpen, out=p.outs)
        for p in away:
            with torch.cuda.stream(p.stream):
                for b, o in zip(p.lead_outs, p.outs):
                    b.copy_(o)
            lead.wait_stream(p.stream)
        for i, out in enumerate(buf.joined):
            torch.cat([p.lead_outs[i] for p in buf.parts], 1, out=out)
        return buf.joined

    def _split_buffers(self, B):
        """The static buffers of the split block at batch size B
        (`_SplitBuffers`), kept for the uncaptured chunks and the
        captures, replaced when B or the tables change (the runner holds
        on to those its graphs were captured with: `_runner`)."""
        held = self.__dict__.get("_split")
        if held is None or held.tables is not self.tables or held.B != B:
            self._split = None
            held = self._split = _SplitBuffers(self, B)
        return held

    @property
    def lm_layout(self) -> LMLayout:
        """The static shape of the block's LM tables."""
        return LMLayout(self.lm_mode, self.V, self.N_BG, self.S_TRI, self.SB,
                        self.N_FAT)

    def _columns(self, tb, kv, ki, ctx_k, fb_k, svk, wpen, out=None):
        """The word-transition block over the entry columns of the block
        tables `tb` (the decoder's own, or one device's part of a "model"
        group, `convert.split_scan_tables`): `ops.transitions`, the CUDA
        kernel on the card.  Each column's LM score from each top-K
        exit's context (the exact trigram row: modes rows, B and C),
        `cand` = exit score + LM score (+ the accept mask), and the first
        winner over K with its payloads.  Returns (entry, am, prw_e,
        ctx_new, erw1, erw2, fb_e) [B, columns], in the tensors of `out`
        when given."""
        return transitions(tb, self.lm_layout, kv, ki, ctx_k, fb_k, svk,
                           wpen, out=out)

    def _step(self, carry, cost, g, t, valid, minimal, mask=False):
        """One frame for B utterances.  cost: this frame's senone costs
        [B, n_sen] (a view of the chunk's; the chain step reads its
        nodes' costs from it by id); g: its costs pre-gathered by gather
        name (see `device_tables`); t: frame index, an int or a 0-d
        int32 tensor on the step's device (the graph's, so that a replay
        reads it); valid [B] bool; `mask`: frames whose valid is false
        leave the carry unchanged.  Returns (new carry, records)."""
        tb = self.tables
        NST, n_rc, W, nE, K = self.NST, self.n_rcp, self.W, self.nE, self.K
        n_multi, SP = self.n_multi, self.SP
        B = valid.shape[0]
        dev = valid.device
        pip = float(np.float32(self.pip))
        wpen = float(np.float32(self.nwpen + self.pip))
        g_fin, g_sp = g.get("fin"), g.get("sp")

        # ---------- chain buckets (multi first + interior phones) and CI
        # chains: one grouped step; it and the fan kernel subtract the
        # last frame's renormalization as they load the scores ----------
        cc, m_prev = carry["chain"], carry["m_prev"]
        (nS, nTF, nCX, nVAR, cl_s, cl_tf, cl_cx,
         esc_c, etf_c, ecx_c) = chain_group_step(
            tb["chain"], cc["S"], cc["TF"], cc["CTX"], cc["VAR"], cost, pip,
            m_prev=m_prev)
        newc = {"chain": dict(S=nS, TF=nTF, CTX=nCX, VAR=nVAR)}
        new_ch, new_ci = self._chain_views(newc["chain"], B)
        # the right-context exit planes of every word [B, n_rc, W]: the
        # fan's, the single-phone words' and the CI chains' columns
        sv = torch.empty((B, n_rc, W), device=dev)
        # ---------- finals fan ----------
        fin_mx = None           # the fan's partial maxima of its new S
        if n_multi:
            e = carry["fin"]
            pred = cl_s + pip                                  # [B, Wm]
            nSf, nTFf, nCXf, _, esc_m, etf_m, ecx_m, fin_mx = fan_step(
                e["S"], e["TF"], e["CTX"], pred, cl_tf, cl_cx, g_fin,
                tb["lp_idx"], tb["tp_fin_rows"], out_f=sv[:, :, :n_multi],
                m_prev=m_prev)
            fin_new = dict(S=nSf, TF=nTFf, CTX=nCXf)
        else:
            fin_new = None
            esc_m = torch.zeros((B, 0), device=dev)
            etf_m = ecx_m = torch.zeros((B, 0), dtype=torch.int32, device=dev)
        # ---------- single-phone columns ----------
        if SP:
            e = carry["sp"]
            sen = tuple(-g_sp[:, j] for j in range(NST))
            newS, (nTF, nCX), out_s, _, (oTF_s, oCX_s) = hmm_step_sm(
                tuple(e["S"].unbind(1)), sen, tb["tp_sp"],
                metas=(tuple(e["TF"].unbind(1)), tuple(e["CTX"].unbind(1))))
            sp_new = dict(S=torch.stack(newS, 1), TF=torch.stack(nTF, 1),
                          CTX=torch.stack(nCX, 1))
            colb, am = torch.max(out_s, dim=1)                 # [B, SP]
            coltf = torch.gather(oTF_s, 1, am[:, None])[:, 0]
            colcx = torch.gather(oCX_s, 1, am[:, None])[:, 0]
            nS_, Cm = self.n_single, self.sp_cmax
            esc_s, am2 = torch.max(colb.view(B, nS_, Cm), dim=2)
            etf_s = torch.gather(coltf.view(B, nS_, Cm), 2, am2[..., None])[..., 0]
            ecx_s = torch.gather(colcx.view(B, nS_, Cm), 2, am2[..., None])[..., 0]
            etg_s = (n_multi + torch.arange(nS_, device=dev)[None, :] * Cm
                     + am2).to(torch.int32)
            torch.amax(out_s.view(B, n_rc, nS_, Cm), dim=3,
                       out=sv[:, :, n_multi:n_multi + nS_])
        else:
            sp_new = None
            esc_s = torch.zeros((B, 0), device=dev)
            etf_s = ecx_s = etg_s = torch.zeros((B, 0), dtype=torch.int32,
                                                device=dev)

        # ---------- word transitions ----------
        escore = torch.cat([esc_m, esc_s, esc_c], 1)              # [B, W]
        etf_w = torch.cat([etf_m, etf_s, etf_c], 1)
        ecx_w = torch.cat([ecx_m, ecx_s, ecx_c], 1)
        etgt0 = tb["etgt0"][None].expand(B, W)
        etgt_w = (torch.cat([etgt0[:, :n_multi], etg_s,
                             etgt0[:, n_multi + self.n_single:]], 1)
                  if SP else etgt0)
        sv[:, :, n_multi + self.n_single:] = esc_c[:, None, :]
        # top-K exits: stable descending sort = jax.lax.top_k tie order;
        # ranks K..K+GM refine the exactness guard (PS_GUARD_TOPM)
        kv2, ki2 = torch.sort(escore, dim=1, descending=True, stable=True)
        kv, ki = kv2[:, :K], ki2[:, :K]
        ctx_k = torch.gather(ecx_w, 1, ki)                        # [B, K]
        fb_k = tb["fb_ci"][ki]
        svk = torch.gather(sv, 2, ki[:, None, :].expand(B, n_rc, K))
        entry, am, prw_e, ctx_new, erw1, erw2, fb_e = self._transitions(
            kv, ki, ctx_k, fb_k, svk, wpen)
        # new left-context class per multi word from the winner's final
        # base phone
        var_new = tb["lc_cls_T"][fb_e[:, :n_multi],
                                 torch.arange(n_multi, device=dev)]
        tf_new = t + 1

        # ---------- apply entries ----------
        inc_segs = []           # pre-entry first-state incumbents
        off = 0
        for bi, ch in enumerate(self.chains):
            self._enter_chain(new_ch[bi], entry, ctx_new, tf_new, off, ch.Wb,
                              tb[f"ch_fm{bi}"], tb[f"ch_fd{bi}"], inc_segs,
                              var_new=var_new[:, off:off + ch.Wb])
            off += ch.Wb
        if SP:
            ent = entry[:, n_multi:n_multi + SP]
            S0 = sp_new["S"][:, 0]
            inc_segs.append(S0.amin(dim=1))
            win = ent[:, None, :] > S0
            sp_new["S"][:, 0] = torch.where(win, ent[:, None, :], S0)
            sp_new["TF"][:, 0] = torch.where(win, tf_new, sp_new["TF"][:, 0])
            sp_new["CTX"][:, 0] = torch.where(
                win, ctx_new[:, None, n_multi:n_multi + SP],
                sp_new["CTX"][:, 0])
        off = n_multi + SP
        for bi, ch in enumerate(self.ci_chains):
            self._enter_chain(new_ci[bi], entry, ctx_new, tf_new, off,
                              ch.Wb, tb[f"ci_fm{bi}"], tb[f"ci_fd{bi}"],
                              inc_segs)
            off += ch.Wb
        newc["fin"] = fin_new
        newc["sp"] = sp_new

        # ---------- top-K exactness guard ----------
        if K < W:
            best_alt = torch.maximum(entry, torch.cat(inc_segs, 1))
            kvK = kv[:, K - 1:K]
            if "guard_w" in tb:
                intop = torch.zeros((B, W), dtype=torch.bool, device=dev)
                intop.scatter_(1, ki, True)
                svf = sv.reshape(B, n_rc * W)
                ce = svf[:, tb["guard_wf"]]                       # [B, J, E]
                live = ~intop[:, tb["guard_w"]]
                breal = torch.where(live, ce + tb["guard_v"],
                                    NEG_INF).amax(dim=1)
                sv_excl = torch.where(intop[:, None, :], NEG_INF, sv)
                plane_E = sv_excl.amax(dim=2)[:, tb["f0p_E"]]     # [B, E]
                rest_kv = kvK
                if self.GM:
                    # ranks K..K+GM: exact per-word bonus rows (fillers
                    # inherit contexts -> the global bound maxb)
                    wm = ki2[:, K:K + self.GM]                    # [B, M]
                    svm = torch.gather(
                        svf, 1, (wm[:, :, None] + tb["f0p_E"] * W)
                        .view(B, -1)).view(B, self.GM, nE)
                    brow = torch.where(tb["isfill_W"][wm][..., None],
                                       tb["maxb_E"],
                                       tb["guard_bmax"][tb["col_lm_W"][wm]])
                    breal = torch.maximum(breal, (svm + brow).amax(dim=1))
                    rest_kv = kv2[:, K + self.GM - 1:K + self.GM]
                breal = torch.maximum(
                    breal, torch.minimum(plane_E, rest_kv) + tb["guard_rest"])
                if "guard_fillwf" in tb:
                    fsv = svf[:, tb["guard_fillwf"]]              # [B,nf,E]
                    flive = ~intop[:, tb["guard_fillw"]][..., None]
                    fbest = torch.where(flive, fsv, NEG_INF).amax(dim=1)
                    breal = torch.maximum(breal, fbest + tb["maxb_E"])
                bound = torch.where(tb["isfill_E"], kvK + tb["fillpen_E"],
                                    breal + wpen)
            else:
                bound = kvK + torch.where(tb["isfill_E"], tb["fillpen_E"],
                                          tb["maxb_E"] + wpen)
            nviol = ((bound > best_alt) & (best_alt > NEG_INF / 2)
                     & valid[:, None]).sum(dim=1, dtype=torch.int32)
        else:
            nviol = torch.zeros(B, dtype=torch.int32, device=dev)

        # ---------- renormalize ----------
        groups = new_ch + new_ci + ([sp_new] if SP else [])
        cols = [x["S"].amax(dim=(1, 2, 3))[:, None] for x in groups]
        # the fan step reduced its planes' maxima (fin_mx [B, P])
        m = torch.cat(cols + ([fin_mx] if n_multi else []), 1).amax(dim=1)
        m = torch.clamp(m, min=NEG_INF)
        # the chain and fan steps subtract m from the carries they read as
        # they load them on the next frame; the single-phone columns take
        # it here
        if SP:
            sp_new["S"].sub_(m[:, None, None, None])
        newc["m_prev"] = m
        if mask:
            newc = self._mask_carry(newc, carry, valid)

        if minimal:
            # top-(K+1) exit records + [E] winner-rank map; slot K pins
            # the finish word's exit
            fi = self.finish_idx if self.finish_idx is not None else 0
            rec = (torch.cat([kv, escore[:, fi:fi + 1]], 1),
                   torch.cat([ki.to(torch.int32),
                              torch.full((B, 1), fi, dtype=torch.int32,
                                         device=dev)], 1),
                   torch.cat([torch.gather(etf_w, 1, ki),
                              etf_w[:, fi:fi + 1]], 1),
                   torch.cat([torch.gather(etgt_w, 1, ki),
                              etgt_w[:, fi:fi + 1]], 1),
                   torch.where(entry > NEG_INF / 2, am, 255).to(torch.uint8),
                   m, nviol)
        else:
            rec = (escore, etf_w, etgt_w, ecx_w, entry,
                   prw_e.to(torch.int32), erw1, erw2, m, nviol)
        return newc, rec

    @staticmethod
    def _enter_chain(e, entry, ctx_new, tf_new, off, Wb, fm, fd, inc_segs,
                     var_new=None):
        """Word entries into a chain bucket's first nodes (state 0,
        strict '>'), in place on the step's fresh planes."""
        ent = entry[:, off:off + Wb]
        S0 = e["S"][:, 0]                                          # [B,D,Wb]
        B = S0.shape[0]
        inc_segs.append(torch.gather(
            S0, 1, fd[None, None, :].expand(B, 1, Wb))[:, 0])
        cand0 = torch.where(fm, ent[:, None, :], NEG_INF)
        win = cand0 > S0
        e["S"][:, 0] = torch.where(win, cand0, S0)
        e["TF"][:, 0] = torch.where(win, tf_new, e["TF"][:, 0])
        e["CTX"][:, 0] = torch.where(win, ctx_new[:, None, off:off + Wb],
                                     e["CTX"][:, 0])
        if var_new is not None:
            winv = (win & fm).any(dim=1)
            e["VAR"][:, 0] = torch.where(winv, var_new, e["VAR"][:, 0])

    def scan(self, costs, valid, minimal=False, graph=None):
        """Run the scan over costs [B, T, n_sen] (tensor on the decoder's
        device) with valid [B, T] bool.  T is padded to a multiple of
        CHUNK; returns the per-frame records stacked to [B, Tp, ...]:
        full (escore, etf, etgt, ecx, entry, eprw, erw1, erw2, m, nviol)
        or minimal (kv, ki, etf, etgt, rank, m, nviol).  `graph`: replay
        the chunk's captured graph (True) or call the chunk uncaptured
        (False); None: the decoder's `graph`."""
        return self._scan(costs, valid, minimal, graph=graph,
                          keep_carry=False)[0]

    def with_carry(self, costs, valid, carry=None, t0=0, graph=None):
        """The streaming scan (JAX `_make_scan(mask_carry=True)
        .with_carry`, batched): the full-record `scan` from `carry` (None:
        `init_carry`) with frames numbered from `t0`; a frame whose
        `valid` is false (a padded block tail) leaves that utterance's
        carry unchanged.  Returns (records [B, Tp, ...], carry after the
        last frame, in buffers of the caller's own)."""
        return self._scan(costs, valid, False, carry, t0, mask=True,
                          graph=graph)

    def _steps(self, carry, cch, vch, t_base, minimal, mask):
        """The frames of costs cch [B, CH, n_sen] and valid vch [B, CH]
        from `carry`, `t_base` the first frame's index (an int, or a 0-d
        int32 tensor on the device): the chunk's senone pre-gather of the
        finals and single-phone columns, then `_step` per frame on its
        cost row and gathered costs.  Yields (frame in the chunk, carry
        after it, its records); a caller that rebinds its carry to each
        one holds no other.  A split decoder's full records of a frame
        hold its joined block outputs (entry, erw1, erw2), which the next
        frame overwrites: copy them before taking the next."""
        B, CH = vch.shape
        gather = self.tables["gather"]
        # chunked pre-gather: this chunk's costs of the finals' and the
        # single-phone columns' senones, one contiguous [CH, B, n] block
        # per gather (the chain kernel reads its own from cch by id)
        gs = {name: cch[:, :, ids].transpose(0, 1).contiguous()
              for name, (ids, _) in gather.items()}
        for i in range(CH):
            g = {name: x[i].view((B,) + gather[name][1])
                 for name, x in gs.items()}
            carry, rec = self._step(carry, cch[:, i], g, t_base + i,
                                    vch[:, i], minimal, mask)
            yield i, carry, rec

    def _scan(self, costs, valid, minimal, carry=None, t0=0, mask=False,
              graph=None, keep_carry=True):
        """The scan of costs and valid padded to whole chunks through the
        decoder's runner (`_runner`): each chunk replays the graph of its
        records and mask (`graph`, None: the decoder's) or is called.
        Returns (records [B, Tp, ...], the carry after the last frame
        with its pending renormalization folded in, in buffers of the
        caller's own, or None when not `keep_carry`)."""
        B, T, n_sen = costs.shape
        Tp = -(-T // CHUNK) * CHUNK
        costs = torch.nn.functional.pad(costs, (0, 0, 0, Tp - T))
        valid = torch.nn.functional.pad(valid, (0, Tp - T))
        self._count_chunks(B, Tp // CHUNK)
        recs, carry = self._runner(B, n_sen).run(
            lambda c, xs, t: self._steps(c, *xs, t, minimal, mask), carry,
            (costs, valid), Tp, t0, (minimal, mask),
            self.graph if graph is None else graph, reset=self._reset_carry)
        if not keep_carry:
            return recs, None
        carry = clone_tree(carry)
        self._fold_renorm(carry, B)
        return recs, carry

    def _count_chunks(self, B, n):
        """Count n chunks of B utterances: their frames in
        "scan.renorm_folded" (the chain and fan steps take the
        renormalization in their load) and, with multi-phone words, in
        "scan.finals_kernel" (the fan step steps the word-final block);
        in "scan.pregather_bytes" the bytes their pre-gathers write (B
        rows of every gather's costs for each frame)."""
        profile.count("scan.pregather_bytes", 4 * B * CHUNK * n * sum(
            ids.numel() for ids, _ in self.tables["gather"].values()))
        profile.count("scan.renorm_folded", CHUNK * n)
        if self.n_multi:
            profile.count("scan.finals_kernel", CHUNK * n)

    def _runner(self, B, n_sen):
        """The decoder's `ChunkGraph` at (B, n_sen) on its tables, kept
        across scans of that shape, with its static carry and a split
        decoder's block buffers of that B (`held`, which the runner's
        graphs write).  A scan of another shape drops it first, so a
        decoder holds at most one static carry."""
        run = self.chunk_graph
        if run is None or not run.fits(self.tables, (B, n_sen)):
            self.chunk_graph = None       # its buffers go first
            run = self.chunk_graph = ChunkGraph(
                self.device, self.tables, (B, n_sen), self.init_carry(B), 1)
            if self.tables["columns"] is not None:
                run.held = self._split_buffers(B)
        if run.held is not None:
            # a step outside the runner at another B may have replaced them
            self._split = run.held
        return run

    # -- 1-best backtrace (device) -------------------------------------------

    def _walk(self, step, t, key, T):
        """Batched segment walk shared by both backtraces: `step(t, key)`
        gives (word, start, next key, done) per utterance.  Returns the
        [B, T, 3] (word, start, end) table (reverse order) and the
        per-utterance segment counts."""
        B = t.shape[0]
        dev = t.device
        out = torch.full((B, T, 3), -1, dtype=torch.int32, device=dev)
        n = torch.zeros(B, dtype=torch.int32, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        reads = 0
        for i in range(T):
            reads += 1
            if bool(done.all()):
                break
            w, s, nxt, fin = step(t, key)
            row = torch.stack([w, s, t], 1).to(torch.int32)
            out[:, i] = torch.where(done[:, None], out[:, i], row)
            n += (~done).to(torch.int32)
            new_done = done | fin
            t = torch.where(new_done, t, s - 1)
            key = torch.where(new_done, key, nxt)
            done = new_done
        profile.count("host_syncs", reads)
        return out, n

    def backtrace(self, escore, etf, etgt, eprw, nf):
        """1-best backtrace over full records [B, T, W|E] (JAX
        `_make_backtrace_jax`, batched).  nf [B] frame counts.
        Returns (table [B, T, 3], n [B], final score [B])."""
        B, T = escore.shape[:2]
        ar = torch.arange(B, device=escore.device)
        nf = torch.as_tensor(nf, device=escore.device).long()
        last = escore[ar, nf - 1]                                  # [B, W]
        w0 = torch.argmax(last, dim=1)
        if self.finish_idx is not None:
            fi = self.finish_idx
            w0 = torch.where(last[:, fi] > NEG_INF / 2, fi, w0)

        def step(t, w):
            s = etf[ar, t, w].long()
            tg = etgt[ar, t, w].long()
            p = torch.where(s > 0, eprw[ar, torch.clamp(s - 1, min=0), tg]
                            .long(), -1)
            return w, s, p, (s <= 0) | (p < 0)

        table, n = self._walk(step, nf - 1, w0, T)
        return table, n, last[ar, w0]

    def backtrace_min(self, kv, ki, etf, etgt, rank, nf):
        """Backtrace over minimal records (JAX `_make_backtrace_min`,
        batched): the walk carries the top-K rank instead of the word."""
        B, T, K1 = kv.shape
        ar = torch.arange(B, device=kv.device)
        nf = torch.as_tensor(nf, device=kv.device).long()
        last = kv[ar, nf - 1]                                      # [B, K1]
        r0 = torch.argmax(last[:, :K1 - 1], dim=1)
        if self.finish_idx is not None:
            r0 = torch.where(last[:, K1 - 1] > NEG_INF / 2, K1 - 1, r0)

        def step(t, r):
            w = ki[ar, t, r].long()
            s = etf[ar, t, r].long()
            tg = etgt[ar, t, r].long()
            pr = torch.where(s > 0, rank[ar, torch.clamp(s - 1, min=0), tg]
                             .long(), 255)
            return w, s, pr, (s <= 0) | (pr >= K1 - 1)

        table, n = self._walk(step, nf - 1, r0, T)
        return table, n, last[ar, r0]

    # -- decode --------------------------------------------------------------

    def scoring(self):
        """The scoring tensors `decode` and `decode_batch` score with: the
        decoder's device's, or split over its "model" group."""
        if self.model_devices:
            return self.am.scoring_shards(self.model_devices)
        return self.am.scoring_tensors(self.device)

    def decode(self, feats, costs=None):
        """Decode one utterance: feats [T, F, L] (or costs [T, n_sen]
        given directly).  Returns (hyp, segs); sets `hyp_score`,
        `guard_violations` and the lazily copied `records`."""
        if costs is None:
            feats = torch.as_tensor(feats, device=self.device)
            costs = senone_scores(self.scoring(), feats[None])[0]
        costs = torch.as_tensor(costs, device=self.device).to(torch.float32)
        T = costs.shape[0]
        raw = self.scan(costs[None], torch.ones((1, T), dtype=torch.bool,
                                                device=self.device))
        raw = tuple(r[0] for r in raw)
        self.raw_records = lambda: tuple(r.cpu().numpy() for r in raw)
        self.records = lambda: self.adapt_records(self.raw_records, T)
        self._raw_dev = (raw, T)
        # top-K exactness guard count
        self.guard_violations = int(raw[9][:T].sum())
        table, n, sc = self.backtrace(raw[0][None], raw[1][None],
                                      raw[2][None], raw[5][None], [T])
        # un-renormalized path score: final winner score + the per-frame
        # renorm offsets the scan subtracted (src/ngram_search.c:545)
        self.hyp_score = float(sc[0]) + float(raw[8][:T - 1].cpu().numpy()
                                              .sum())
        return self._segs_from_table(table[0].cpu().numpy(), int(n[0]))

    def decode_batch(self, feats, n_frames, keep_records=True, costs=None,
                     timings=None, graph=None):
        """Batched decode of feats [B, T, F, L] with n_frames [B].
        keep_records=False uses the top-K-compressed minimal record
        stream (`batch_records` is then None).  `costs` [B, T, n_sen]
        skips the scoring.  A dict passed as `timings` receives the
        seconds of the scoring, scan and backtrace stages (the device is
        synchronized at each stage boundary).  `graph` as in `scan`.
        The stages are `profile` spans; the batch counts its frames and
        its blocking reads of results in `profile`'s counters."""
        minimal = not keep_records and min(self.topk, self.W) <= 254
        if not keep_records and not minimal:
            warnings.warn(
                f"keep_records=False requested but topk={self.topk} "
                f"exceeds the uint8 rank-map limit (254): falling back "
                f"to full [T, E] records.", RuntimeWarning, stacklevel=2)
        dev = self.device
        with profile.span("ps.scoring", timings, "scoring", dev):
            if costs is None:
                feats = torch.as_tensor(feats, device=dev)
                costs = senone_scores(self.scoring(), feats, time_chunk=16)
            costs = torch.as_tensor(costs, device=dev).to(torch.float32)
            B, T = costs.shape[:2]
            if torch.is_tensor(n_frames):
                profile.count("host_syncs")
                n_frames = n_frames.cpu().numpy()
            nf = np.asarray(n_frames).astype(np.int64)
        profile.count("scan.batches")
        profile.count("scan.lane_frames", B * -(-T // CHUNK) * CHUNK)
        profile.count("scan.real_frames", int(nf.sum()))
        with profile.span("ps.scan", timings, "scan", dev):
            valid = (torch.arange(T, device=dev)[None, :]
                     < torch.as_tensor(nf, device=dev)[:, None])
            raw = self.scan(costs, valid, minimal=minimal, graph=graph)
        with profile.span("ps.backtrace", timings, "backtrace", dev):
            if minimal:
                tables, ns, scs = self.backtrace_min(*raw[:5], nf)
                viol, m_rec = raw[6], raw[5]
                self.batch_records = None
            else:
                tables, ns, scs = self.backtrace(raw[0], raw[1], raw[2],
                                                 raw[5], nf)
                viol, m_rec = raw[9], raw[8]
                self.batch_records = _LazyBatchRecords(self, raw, nf)
            with profile.span("ps.backtrace.to_host"):
                profile.count("host_syncs", 5)
                tables, ns = tables.cpu().numpy(), ns.cpu().numpy()
                scs, m_rec = scs.cpu().numpy(), m_rec.cpu().numpy()
                viol = viol.cpu().numpy()
        with profile.span("ps.segments"):
            self.hyp_scores = [
                float(scs[b]) + float(m_rec[b, :max(nf[b] - 1, 0)].sum())
                for b in range(B)]
            self.guard_violations_batch = [
                int(viol[b, :nf[b]].sum()) for b in range(B)]
            self.guard_violations = int(sum(self.guard_violations_batch))
            return [self._segs_from_table(tables[b], int(ns[b]))
                    for b in range(B)]

    def _backtrace(self, recs, T):
        """Host 1-best walk over one utterance's flat records (escore,
        estf, eprw, ...) [T, W], or raw scan records (adapted first), as
        the JAX `_backtrace` (the `ngram_flat` walk): start at the finish
        word's exit if it is alive at T-1, else the best exit.  Returns
        (hyp, segs)."""
        if len(recs) >= 9:
            recs = self.adapt_records(recs, T)
        escore, estf, eprw = [np.asarray(r) for r in recs[:3]]
        last = escore[T - 1]
        if (self.finish_idx is not None
                and last[self.finish_idx] > NEG_INF / 2):
            w = self.finish_idx
        else:
            w = int(np.argmax(last))
        segs = []
        t = T - 1
        while t >= 0 and w >= 0:
            s = int(estf[t, w])
            segs.append(Seg(word=self.dict.wordstr(self.words[w]),
                            start=s, end=t))
            p = int(eprw[t, w])
            if s <= 0 or p < 0:
                break
            w = p
            t = s - 1
        segs.reverse()
        return self._hyp_of(segs), segs

    def _segs_from_table(self, table, n):
        """[n, 3] (word, start, end) rows (reverse order) -> (hyp, segs)."""
        segs = []
        for i in range(int(n) - 1, -1, -1):
            wi, s, t = (int(x) for x in table[i])
            segs.append(Seg(word=self.dict.wordstr(self.words[wi]),
                            start=s, end=t))
        return self._hyp_of(segs), segs

    def _hyp_of(self, segs):
        """The hypothesis string of segments: their real words' base
        forms."""
        out = []
        for s in segs:
            wid = self.dict.wordid(s.word)
            if wid < 0 or self.dict.is_filler(wid):
                continue
            out.append(self.dict.basestr(wid))
        return " ".join(out)

    # -- records adapter -----------------------------------------------------

    @property
    def records(self):
        """Adapted per-frame records (escore, estf, eprw, eascr, eh1,
        eh2, ectx).  Computed lazily: the dense [T, W]/[T, E] arrays
        only leave the device when a consumer (tests) asks."""
        r = self._records
        if callable(r):
            r = r()
            self._records = r
        return r

    @records.setter
    def records(self, value):
        self._records = value
        self._raw_dev = None

    def lattice_inputs(self):
        """What the lattice's exit scan reads from the current records:
        (escore, estf [T, W], ascr_at), where ascr_at(t, w) gives the
        segment acoustic scores (the flat records' eascr) of exits (t, w).
        After `decode` these are the raw records on the device, and only
        the exits asked for reach the host; records set from elsewhere (a
        stream's) are the host flat records."""
        if getattr(self, "_raw_dev", None) is None:
            r = self.records
            return r[0], r[1], lambda t, w: np.asarray(r[3])[t, w]
        raw, T = self._raw_dev
        return raw[0][:T], raw[1][:T], lambda t, w: self._ascr_at(raw, T,
                                                                  t, w)

    def _ascr_at(self, raw, T, t, w):
        """eascr of `adapt_records` at exits (t, w), gathered from the raw
        device records (same host arithmetic, element for element)."""
        escore, etf, etgt, _, entv = raw[:5]
        dev = escore.device
        ti, wi = torch.as_tensor(t, device=dev), torch.as_tensor(w, device=dev)
        tf, tg = etf[ti, wi].long(), etgt[ti, wi].long()
        en = entv[torch.clamp(tf - 1, 0, T - 1), tg].cpu().numpy()
        Mcp = np.concatenate([[0.0], np.cumsum(raw[8][:T].cpu().numpy())])
        return _eascr(escore[ti, wi].cpu().numpy(), tf.cpu().numpy(), en,
                      Mcp, t)

    @property
    def raw_records(self):
        r = self._raw_records
        if callable(r):
            r = r()
            self._raw_records = r
        return r

    @raw_records.setter
    def raw_records(self, value):
        self._raw_records = value

    def adapt_records(self, raw, T):
        """Join raw scan records into the flat-record format
        (escore, estf, eprw, eascr, eh1, eh2, ectx) [T, W] consumed by
        the lattice layer and the tests."""
        escore, etf, etgt, ectx, entv, eprw, erw1, erw2, m = \
            [np.asarray(r)[:T] for r in raw[:9]]
        Tn = escore.shape[0]
        Mcp = np.concatenate([[0.0], np.cumsum(m)])  # Mcp[t] = sum m[<t]
        tf = etf.astype(np.int64)
        tg = etgt.astype(np.int64)
        tfi = np.clip(tf - 1, 0, Tn - 1)
        has = tf > 0
        eprw_x = np.where(has, eprw[tfi, tg], -1).astype(np.int32)
        eascr = _eascr(escore, tf, entv[tfi, tg], Mcp,
                       np.arange(Tn)[:, None])
        s_lm = self.lm.wid("<s>") if self.start_idx is not None else -1
        eh1 = np.where(has, erw1[tfi, tg], max(s_lm, 0)).astype(np.int32)
        eh2 = np.where(has, erw2[tfi, tg], self.V).astype(np.int32)
        return (escore.astype(np.float32), tf.astype(np.int32), eprw_x,
                eascr, eh1, eh2, ectx.astype(np.int32))
