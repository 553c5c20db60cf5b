"""N-gram decoding: dense full-vocabulary flat Viterbi ("fwdflat" design)
in torch.

Port of `pocketsphinx_tpu.search.ngram_flat`, the fused search's
exactness oracle.  The network build (`_build`, `_lm_tables`) is a NumPy
copy of the JAX module's; the per-frame step is torch ops on the
decoder's device over `ops.hmm.hmm_step_sm`, with the batch axis written
out ([B, ...]) where the JAX package used `jax.vmap`, and the 1-best
backtrace is the JAX module's Python walk.  The scan (the JAX
`_make_scan`'s `jax.jit`) runs as 16-frame chunks captured once per
batch size as a CUDA graph and replayed (`base.ChunkGraph`; on the CPU,
and with `graph=False`, the same chunk on the same buffers without
capture).

Every dictionary word keeps a dense HMM chain and all words are evaluated
every frame (no pruning).  Exact language-model application at every word
transition (like the reference's second pass, fwdflat, which rescores
with full trigrams, src/ngram_search_fwdflat.c:813).

Per frame:
  1. dense HMM update over all word chains (per-state [B, P] planes,
     emissions on source states per src/hmm.c:222-350);
  2. word exits per right-context class (the bestbp_rc / xwdssid design
     of src/ngram_search.c:378-500 and src/dict2pid.c, kept dense as a
     [W, n_class] slice of the exit vector);
  3. word entries: a [W, W] max-plus product of exit scores with the
     trigram successor rows (gathered per exiting word's carried history
     class), silence/filler transitions with silpen/fillpen
     (src/ngram_search.c:115-120), reduced by the source's final base CI
     phone in static slices of the sources sorted by it;
  4. dense per-frame records (exit score/start/history, entry argmax) --
     the backpointer-table equivalent, consumed by the host backtrace.

Memory: the step holds [B, W, W] float32 planes (the exit gather, the LM
rows, their sum) besides the [R, W] LM rows and the [W, W] exit-slot
table; W = 20,048 makes each plane 1.6 GB, so at the 20k width the card
decodes B=1 or 2 (PERF.md gives the arithmetic).

Carried state: scores S, word-entry frame STF, LM histories RW1/RW2 (most
recent real word and its predecessor, the bptable's real_wid /
prev_real_wid), the source word PRW, the entry score ENTV and the history
class CTX, each a tuple of NST planes [B, P]; a frame whose `valid` is
false leaves a row's carry as it was.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import profile, resolve_device
from ..lm.ngram import NgramModel
from ..models.acoustic import AcousticModel, UNIT_NATS, senone_scores
from ..models.dict2pid import Dict2Pid
from ..ops.hmm import hmm_step_sm
from .base import CHUNK, ChunkGraph, clone_tree, frames

NEG_INF = -1e30
SHIFT = 1 << 10


@dataclass
class Seg:
    word: str
    start: int
    end: int            # inclusive frame
    ascr: float = 0.0
    lscr: float = 0.0


class NgramFlatDecoder:
    """Exact-trigram full-vocabulary flat Viterbi on `device` (CUDA unless
    `device="cpu"`)."""

    def __init__(self, am: AcousticModel, d2p: Dict2Pid, lm: NgramModel,
                 silprob: float = 0.005, fillprob: float = 1e-8,
                 pip: float = 1.0, nwpen: float = 1.0, device=None,
                 graph: bool = True):
        self.device = resolve_device(device)
        #: replay the scan's captured chunks (default) or, with False,
        #: call them uncaptured (`with_carry(..., graph=)` overrides it)
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
        self.batch_records = None
        self.rebuild()

    def rebuild(self):
        """Rebuild the network after the dictionary or the LM changed; the
        device tables are made again on first use."""
        self._build()

    def to(self, device, graph=None) -> "NgramFlatDecoder":
        """A decoder sharing this one's host network, with its tables on
        `device` (e.g. to check a CUDA run against the CPU); `graph`
        (default this one's) as the constructor's."""
        other = object.__new__(type(self))
        other.__dict__.update(self.__dict__)
        other.device = torch.device(device)
        if graph is not None:
            other.graph = graph
        other.tables = None
        other.chunk_graph = None
        return other

    # -- static structure ----------------------------------------------------

    def _build(self):
        # invalidate the device and LM tables (rebuilds after
        # add_word/load_dict)
        self.tables = None
        self._lm_rows = None
        self._ctx_next = None
        d, mdef, d2p, lm = self.dict, self.mdef, self.d2p, self.lm
        sil = mdef.sil
        # Search words: dictionary words with an LM unigram (any alternate
        # maps to its base's string) + filler words.  <s> is the start
        # word; </s> the finish word.
        words = []          # dict wids
        lm_wid = []         # LM wid or -1 (fillers)
        is_fill = []
        for wid in range(len(d)):
            base = d.basestr(wid)
            lw = lm.wid(base)
            if d.is_filler(wid) and wid not in (d.startwid, d.finishwid):
                words.append(wid)
                lm_wid.append(-1)
                is_fill.append(True)
            elif lw >= 0:
                words.append(wid)
                lm_wid.append(lw)
                is_fill.append(False)
        self.words = words
        self.lm_wid = np.array(lm_wid, dtype=np.int32)
        self.is_fill = np.array(is_fill, dtype=bool)
        W = len(words)
        self.W = W
        self.widx = {w: i for i, w in enumerate(words)}
        self.start_idx = None
        self.finish_idx = None

        # Build phone chains with exact cross-word triphones on both
        # boundaries (mpx first phones; see models/chains.py).
        from ..models.chains import ChainRows, append_word_chain_mpx
        rows = ChainRows()
        n_ci = mdef.n_ciphone
        first_node = np.zeros(W, np.int32)
        f0_arr = np.zeros(W, np.int32)
        fb_ci = np.zeros(W, np.int32)      # final base CI phone per word
        chains = []
        slot_base = np.zeros(W + 1, np.int64)
        for i, wid in enumerate(words):
            f0_arr[i] = int(d.pron(wid)[0])
            ch = append_word_chain_mpx(rows, d, mdef, d2p, wid, i, n_ci)
            chains.append(ch)
            first_node[i] = ch.first_lo
            fb_ci[i] = ch.final_base_ci
            slot_base[i + 1] = slot_base[i] + ch.n_slot
        P = len(rows)
        self.P = P
        n_slot = int(slot_base[W])
        self.n_slot = n_slot
        self.senid = np.asarray(rows.senid, dtype=np.int32)
        tmatid = np.asarray(rows.tmat, dtype=np.int32)
        tpc = self.am.tmat.tp[tmatid].astype(np.float32)
        self.tp = np.where(tpc == 255, NEG_INF, -tpc)
        chain_pred = np.asarray(rows.chain_pred, dtype=np.int32)
        self.chain_pred = chain_pred
        self.node_word = np.asarray(rows.owner, dtype=np.int32)
        self.first_node = first_node
        self.fb_ci = fb_ci
        self.f0_arr = f0_arr

        # group-predecessor nodes (-2): predecessor is the whole
        # first-variant group of their word; fg_id names that group
        self.pred_is_group = chain_pred == -2
        self.fg_id = np.full(P, W, np.int64)       # W = no group
        # entry masks [P, n_ci]: node accepts word entries from sources
        # whose final base CI phone is set
        entry_mask = np.zeros((P, n_ci), bool)
        # exit slots: final-phone nodes -> global slot id (n_slot = none)
        node_slot = np.full(P, n_slot, np.int64)
        # per-word map entering-word -> slot offset, and word of slots
        exit_slot = np.zeros((W, W), np.int32)
        self.slot_word = np.zeros(n_slot, np.int32)
        for i, ch in enumerate(chains):
            if ch.filler:
                entry_mask[ch.first_lo, :] = True
            elif ch.single:
                n_rc = ch.n_slot
                for o in range(ch.first_hi - ch.first_lo):
                    entry_mask[ch.first_lo + o] = ch.lc_cls == (o // n_rc)
            else:
                self.fg_id[ch.first_lo:ch.first_hi] = i
                for o in range(ch.first_hi - ch.first_lo):
                    entry_mask[ch.first_lo + o] = ch.lc_cls == o
            for node, so in ch.final_nodes:
                node_slot[node] = slot_base[i] + so
                self.slot_word[slot_base[i] + so] = i
            exit_slot[i] = slot_base[i] + ch.rc_cls[f0_arr]
        self.entry_mask = entry_mask
        self.node_slot = node_slot
        self.exit_slot = exit_slot
        # any-context exit slot (records/lattice): the SIL rc class
        self.exit_slot_sil = np.array(
            [slot_base[i] + chains[i].rc_cls[sil] for i in range(W)],
            np.int32)

        # Static reduction tables (dense padded-gather group maxima):
        #   slot_members [n_slot, Ks]: final nodes per exit slot (pad P)
        #   word_slots   [W, Kw]:      slots per word (pad n_slot)
        #   fg_members   [W, Kg]:      first-phone variants per word
        #                              with a group-pred consumer (pad P)
        #   fb_perm/fb_bounds: source words sorted by final base CI so
        #                      per-ci maxima reduce over static slices
        def padded(groups, n, pad):
            k = max((len(g) for g in groups), default=1) or 1
            m = np.full((n, k), pad, np.int64)
            for i, g in enumerate(groups):
                m[i, :len(g)] = g
            return m

        by_slot = [[] for _ in range(n_slot)]
        for p in np.nonzero(node_slot < n_slot)[0]:
            by_slot[node_slot[p]].append(int(p))
        self.slot_members = padded(by_slot, n_slot, P)
        self.word_slots = padded(
            [list(range(slot_base[i], slot_base[i + 1]))
             for i in range(W)], W, n_slot)
        by_fg = [[] for _ in range(W)]
        for p in np.nonzero(self.fg_id < W)[0]:
            by_fg[self.fg_id[p]].append(int(p))
        self.fg_members = padded(by_fg, W, P)
        self.fb_perm = np.argsort(fb_ci, kind="stable").astype(np.int64)
        self.fb_bounds = np.searchsorted(fb_ci[self.fb_perm],
                                         np.arange(n_ci + 1))

        if d.startwid in self.widx:
            self.start_idx = self.widx[d.startwid]
        if d.finishwid in self.widx:
            self.finish_idx = self.widx[d.finishwid]

        # Device-resident LM: one dense successor row per history
        # equivalence class (unigram / per-h1 bigram / per-(h2,h1)
        # trigram context), gathered per frame by a carried row index.
        V = lm.counts[0]
        self.V = V
        # map decoder word -> lm wid for successor lookup columns
        self.col_lm = np.where(self.lm_wid >= 0, self.lm_wid, 0)

    # Memory budget for the dense LM row table ([1+V+n_bigrams, W] f32).
    # Above it, trigram context rows are dropped and the search is exact
    # bigram (trigram knowledge then enters via bestpath rescoring).
    LM_TABLE_BUDGET = None   # default: env PS_LM_TABLE_BYTES or 2 GiB

    def _lm_tables(self):
        """(rows [R, W] f32 shifted-unit scores, ctx_next [V+1, W] i32).

        rows[r] is the exact weighted successor score of every decoder
        word under history class r (0 = empty, 1+h = (h,), 1+V+b =
        bigram entry b's two-word context).  ctx_next[h1, w] is the row
        the search carries after entering real word w when the previous
        real word was h1 (V = no previous word): the trigram context
        row when the LM knows bigram (h1, w), else w's bigram row --
        exact Katz semantics, since bo(h1, w) = 0 for unseen contexts.
        The full-trigram search so costs one [W, W] row gather per frame,
        like a bigram search."""
        if getattr(self, "_lm_rows", None) is not None:
            return self._lm_rows, self._ctx_next
        lm, V, W = self.lm, self.V, self.W
        budget = self.LM_TABLE_BUDGET
        if budget is None:
            budget = int(os.environ.get("PS_LM_TABLE_BYTES", 2 << 30))
        rows, with_tri = lm.dense_context_rows(self.col_lm, budget)
        rows = rows / SHIFT
        rows[:, self.is_fill] = 0.0
        self.lm_order_used = 3 if with_tri else (2 if lm.order >= 2 else 1)
        ctx_next = np.empty((V + 1, W), dtype=np.int32)
        ctx_next[:, :] = (1 + self.col_lm)[None, :]
        if with_tri:
            # vectorized scatter of trigram-context successors
            ho, hn = lm.bigram_entries()
            real_cols = np.nonzero(~self.is_fill)[0]
            key = self.col_lm[real_cols]
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
                ctx_next[r_idx, c_idx] = v_idx
        self._lm_rows, self._ctx_next = rows, ctx_next
        return rows, ctx_next

    # -- device tables -------------------------------------------------------

    def _tables(self) -> dict:
        """The step's tensors on the decoder's device (made on first use):
        the JAX `_make_scan`'s constants.  The [W, W] exit-slot table is
        stored with its source rows in final-base order (`fb_perm`), so the
        step builds the per-CI-sorted transition plane directly."""
        if self.tables is not None:
            return self.tables
        dev = self.device
        t = lambda x: torch.as_tensor(np.ascontiguousarray(x),  # noqa: E731
                                      device=dev)
        rows, ctx_next = self._lm_tables()
        fill_cols = np.nonzero(self.is_fill)[0]
        sil_w = np.array([self.words[i] == self.dict.silwid
                          for i in range(self.W)])
        self.tables = dict(
            senid=t(self.senid.T.astype(np.int64)),         # [NST, P]
            tp=t(self.tp),                                  # [P, NST, NST+1]
            chain_pred=t(np.maximum(self.chain_pred, 0).astype(np.int64)),
            has_pred=t(self.chain_pred >= 0),
            pred_grp=t(self.pred_is_group),
            is_entry=t(self.chain_pred == -1),
            entry_mask_T=t(self.entry_mask.T),              # [n_ci, P]
            node_word=t(self.node_word.astype(np.int64)),
            exit_slot_perm=t(self.exit_slot[self.fb_perm]),  # [W, W] i32
            lm_rows=t(rows),                                # [R, W]
            ctx_next=t(ctx_next.reshape(-1)),               # [(V+1) W]
            is_real=t(~self.is_fill),
            lm_wid=t(self.col_lm.astype(np.int32)),
            fill_cols=t(fill_cols.astype(np.int64)),
            fillpen_fill=t(np.where(sil_w, self.silpen, self.fillpen)
                           .astype(np.float32)[fill_cols]),
            slot_members=t(self.slot_members),
            word_slots=t(self.word_slots),
            fg_members=t(self.fg_members),
            fb_perm=t(self.fb_perm),
            fb_perm32=t(self.fb_perm.astype(np.int32)))
        return self.tables

    def init_carry(self, B: int):
        """The carry at frame 0 for B utterances: a tuple of the seven
        state channels, each a tuple of NST planes [B, P]."""
        NST, P, V = self.mdef.n_emit_state, self.P, self.V
        S0 = np.full((NST, P), NEG_INF, np.float32)
        STF0 = np.zeros((NST, P), np.int32)
        RW10 = np.zeros((NST, P), np.int32)
        RW20 = np.full((NST, P), V, np.int32)   # V = "no history"
        PRW0 = np.full((NST, P), -1, np.int32)
        ENTV0 = np.zeros((NST, P), np.float32)
        CTX0 = np.zeros((NST, P), np.int32)     # row 0 = empty history
        if self.start_idx is not None:
            s_lm = self.lm.wid("<s>")
            S0[0, self.first_node[self.start_idx]] = 0.0
            RW10[0, self.first_node[self.start_idx]] = max(s_lm, 0)
            if s_lm >= 0:
                # history after <s> is (<s>,): its bigram row
                CTX0[0, self.first_node[self.start_idx]] = 1 + s_lm
        return tuple(
            tuple(torch.as_tensor(arr[j], device=self.device)
                  .expand(B, P).clone() for j in range(NST))
            for arr in (S0, STF0, RW10, RW20, PRW0, ENTV0, CTX0))

    # -- the per-frame step --------------------------------------------------

    @staticmethod
    def _members_max(vals_pad, members):
        """(max, winning member) per row of a padded index matrix
        members [G, K] over vals_pad [B, N]: a segment max + first
        argmax."""
        v = vals_pad[:, members]                        # [B, G, K]
        mx, k = v.max(dim=2)
        return mx, members[None].expand(v.shape[0], -1, -1).gather(
            2, k[..., None])[..., 0]

    def _step(self, carry, cost_t, t, valid):
        """One frame for B utterances: cost_t [B, n_sen], t the frame
        number (0-dim int32 tensor), valid [B] bool.  Returns (carry,
        records (escore, estf, eprw, eascr, eh1, eh2, ectx) [B, W])."""
        g = self._tables()
        S, STF, RW1, RW2, PRW, ENTV, CTX = carry
        B = cost_t.shape[0]
        P, W, n_slot = self.P, self.W, self.n_slot
        NST = self.mdef.n_emit_state
        nw = g["node_word"]
        sen_t = tuple(-cost_t[:, g["senid"][j]] for j in range(NST))
        newS, (nSTF, nRW1, nRW2, nPRW, nENTV, nCTX), out, _, \
            (o_stf, o_rw1, o_rw2, o_prw, o_entv, o_ctx) = hmm_step_sm(
                S, sen_t, g["tp"], metas=(STF, RW1, RW2, PRW, ENTV, CTX))
        out_pad = torch.cat([out, out.new_full((B, 1), NEG_INF)], dim=1)
        # intra-word chain entry: single predecessor, or max over the
        # word's first-phone variant group (mpx fan-in)
        gmax, garg = self._members_max(out_pad, g["fg_members"])   # [B, W]
        garg = torch.clamp(garg, max=P - 1)
        ce_plain = torch.where(g["has_pred"], out[:, g["chain_pred"]],
                               NEG_INF)
        chain_entry = torch.where(g["pred_grp"], gmax[:, nw],
                                  ce_plain) + self.pip
        src_node = torch.where(g["pred_grp"], garg[:, nw],
                               g["chain_pred"])                     # [B, P]
        ch_win = chain_entry > newS[0]

        def chw(newv, oldv):
            return torch.where(ch_win, newv.gather(1, src_node), oldv)
        s0 = torch.where(ch_win, chain_entry, newS[0])
        stf0 = chw(o_stf, nSTF[0])
        rw10 = chw(o_rw1, nRW1[0])
        rw20 = chw(o_rw2, nRW2[0])
        prw0 = chw(o_prw, nPRW[0])
        entv0 = chw(o_entv, nENTV[0])
        ctx0 = chw(o_ctx, nCTX[0])

        # word exits: per-slot best (rc-class fan, with single-phone words
        # reduced over their lc variants), plus per-word best for the
        # records/history (the bptable's one-entry-per-word semantics)
        sv, snode = self._members_max(out_pad, g["slot_members"])  # [B, S]
        sv_pad = torch.cat([sv, sv.new_full((B, 1), NEG_INF)], dim=1)
        escore, wslot = self._members_max(sv_pad, g["word_slots"])  # [B, W]
        wnode = snode.gather(1, torch.clamp(wslot, max=n_slot - 1))
        wnode = torch.clamp(wnode, max=P - 1)
        eh1 = o_rw1.gather(1, wnode)                     # [B, W]
        eh2 = o_rw2.gather(1, wnode)
        ectx = o_ctx.gather(1, wnode)
        estf = o_stf.gather(1, wnode)
        eprw = o_prw.gather(1, wnode)
        eascr = escore - o_entv.gather(1, wnode)
        # exact n-gram scores for every (exiting e -> entering w), the
        # sources in final-base order: exit score + LM row of the exit's
        # carried history class (fillers: + silpen / fillpen)
        perm = g["fb_perm"]
        ts = sv.index_select(1, g["exit_slot_perm"].view(-1)).view(B, W, W)
        fc = g["fill_cols"]
        exg_fill = ts[:, :, fc] + g["fillpen_fill"]
        ts += g["lm_rows"].index_select(
            0, ectx[:, perm].reshape(-1)).view(B, W, W)
        ts += self.nwpen + self.pip
        ts[:, :, fc] = exg_fill
        # reduce sources by their final base CI phone (static slices),
        # then select per entry node through its left-context-class mask
        tbf_rows, argf_rows = [], []
        fb_bounds = self.fb_bounds
        for ci in range(self.mdef.n_ciphone):
            b0, b1 = int(fb_bounds[ci]), int(fb_bounds[ci + 1])
            if b0 == b1:
                tbf_rows.append(ts.new_full((B, W), NEG_INF))
                argf_rows.append(torch.zeros((B, W), dtype=torch.int32,
                                             device=ts.device))
                continue
            mx, am = ts[:, b0:b1].max(dim=1)
            tbf_rows.append(mx)
            argf_rows.append(g["fb_perm32"][b0 + am])
        tbf = torch.stack(tbf_rows, 1)                   # [B, n_ci, W]
        argf = torch.stack(argf_rows, 1)                 # [B, n_ci, W]
        tv = torch.where(g["entry_mask_T"], tbf[:, :, nw], NEG_INF)
        e_node, ci_star = tv.max(dim=1)                  # [B, P]
        e_star = argf.view(B, -1).gather(1, ci_star * W + nw)   # i32
        e_star_l = e_star.long()
        src_rw1 = eh1.gather(1, e_star_l)
        src_rw2 = eh2.gather(1, e_star_l)
        w_real = g["is_real"][nw]
        new_rw1 = torch.where(w_real, g["lm_wid"][nw], src_rw1)
        new_rw2 = torch.where(w_real, src_rw1, src_rw2)
        # carried history class after the transition: trigram ctx
        # (h1_prev, w) for real words, the source's class for fillers
        new_ctx = torch.where(
            w_real, g["ctx_next"][src_rw1.long() * W + nw],
            ectx.gather(1, e_star_l))
        ewin = g["is_entry"] & (e_node > s0)
        s0 = torch.where(ewin, e_node, s0)
        stf0 = torch.where(ewin, t + 1, stf0)
        rw10 = torch.where(ewin, new_rw1, rw10)
        rw20 = torch.where(ewin, new_rw2, rw20)
        prw0 = torch.where(ewin, e_star, prw0)
        entv0 = torch.where(ewin, e_node, entv0)
        ctx0 = torch.where(ewin, new_ctx, ctx0)
        newS = (s0,) + newS[1:]
        m = torch.clamp(torch.stack([x.amax(dim=1) for x in newS], 1)
                        .amax(dim=1), min=NEG_INF)[:, None]
        newS = tuple(x - m for x in newS)
        nENTV = (entv0 - m,) + tuple(x - m for x in nENTV[1:])
        new = (newS, (stf0,) + nSTF[1:], (rw10,) + nRW1[1:],
               (rw20,) + nRW2[1:], (prw0,) + nPRW[1:], nENTV,
               (ctx0,) + nCTX[1:])
        v = valid[:, None]
        carry = tuple(tuple(torch.where(v, a, b) for a, b in zip(nc, oc))
                      for nc, oc in zip(new, carry))
        return carry, (escore, estf, eprw, eascr, eh1, eh2, ectx)

    def with_carry(self, costs, valid, carry=None, t0=0, graph=None):
        """Scan costs [B, T, n_sen] (on the decoder's device) with valid
        [B, T] bool from `carry` (None: `init_carry`), frames numbered from
        `t0`; a frame whose `valid` is false leaves that row's carry as it
        was.  The frames run through the `base.ChunkGraph` of this (B,
        n_sen), T padded to whole chunks with valid=False frames; `graph`
        (None: the decoder's): replay the chunk's captured graph or call
        it uncaptured.  The decoder keeps one runner, of its tables and
        last (B, n_sen).  Returns (records, each [B, T, W], the carry after
        the last frame)."""
        B, T, n_sen = costs.shape
        if carry is None:
            carry = self.init_carry(B)
        Tp = -(-T // CHUNK) * CHUNK
        costs = torch.nn.functional.pad(costs, (0, 0, 0, Tp - T))
        valid = torch.nn.functional.pad(valid, (0, Tp - T))
        tables = self._tables()
        run = self.chunk_graph
        if run is None or not run.fits(tables, (B, n_sen)):
            self.chunk_graph = None       # its buffers go first
            run = self.chunk_graph = ChunkGraph(self.device, tables,
                                                 (B, n_sen), axis=1)
        recs, carry = run.run(
            frames(lambda c, cost_t, v, t: self._step(c, cost_t, t, v), 1),
            carry, (costs, valid), Tp, t0,
            capture=self.graph if graph is None else graph)
        return tuple(r[:, :T] for r in recs), clone_tree(carry)

    def scan(self, costs, valid, graph=None):
        """The records [B, T, W] of costs [B, T, n_sen] with valid [B, T]
        from the start of an utterance (`graph` as in `with_carry`)."""
        return self.with_carry(costs, valid, graph=graph)[0]

    # -- decode --------------------------------------------------------------

    def _costs(self, feats, costs):
        if costs is None:
            feats = torch.as_tensor(feats, device=self.device).to(
                torch.float32)
            squeeze = feats.dim() == 3
            costs = senone_scores(self.am.scoring_tensors(self.device),
                                  feats[None] if squeeze else feats)
            return costs[0] if squeeze else costs
        return torch.as_tensor(costs, device=self.device).to(torch.float32)

    def decode(self, feats, costs=None):
        """feats [T, F, L] (or costs [T, n_sen] given directly) ->
        (hyp string, list of Seg); keeps the host `records`."""
        costs = self._costs(feats, costs)
        T = costs.shape[0]
        recs = self.scan(costs[None], torch.ones((1, T), dtype=torch.bool,
                                                 device=self.device))
        self.records = tuple(r[0].cpu().numpy() for r in recs)
        return self._backtrace(self.records, T)

    def decode_batch(self, feats, n_frames, costs=None, keep_records=True,
                     timings=None):
        """Batched decode: feats [B, T, F, L] (padded; or costs [B, T,
        n_sen]), n_frames [B] -> list of (hyp, segs).  Scoring and the
        scan run on the device for the whole batch; backtrace per
        utterance on the host.  Per-utterance records are kept in
        `batch_records` (None without `keep_records`); `records` is not
        changed.  A dict passed as `timings` receives the seconds of the
        scoring, the scan and the backtrace (the device synchronized at
        each boundary), as `NgramFusedDecoder.decode_batch`'s; the stages
        are its `profile` spans."""
        dev = self.device
        with profile.span("ps.scoring", timings, "scoring", dev):
            costs = self._costs(feats, costs)
        B, T = costs.shape[:2]
        with profile.span("ps.scan", timings, "scan", dev):
            nf = (n_frames.cpu().numpy() if torch.is_tensor(n_frames)
                  else np.asarray(n_frames)).astype(np.int64)
            valid = (torch.arange(T, device=dev)[None, :]
                     < torch.as_tensor(nf, device=dev)[:, None])
            recs = tuple(r.cpu().numpy() for r in self.scan(costs, valid))
        with profile.span("ps.backtrace", timings, "backtrace", dev):
            batch_records = []
            out = []
            for b in range(B):
                per_utt = tuple(r[b] for r in recs)
                batch_records.append(per_utt)
                out.append(self._backtrace(per_utt, int(nf[b])))
            self.batch_records = batch_records if keep_records else None
        return out

    #: the flat search is exact (no top-K shortlist): no guard counts
    guard_violations = 0
    #: the scan's `ChunkGraph` (None before its first scan through it)
    chunk_graph = None

    def adapt_records(self, raw, T):
        """Streamed records are already flat records: the first T frames."""
        return tuple(np.asarray(r)[:T] for r in raw)

    def lattice_inputs(self):
        """(escore, estf [T, W], ascr_at) of the current records for the
        lattice's exit scan."""
        r = self.records
        return r[0], r[1], lambda t, w: np.asarray(r[3])[t, w]

    def _backtrace(self, recs, T):
        """Host 1-best walk (the JAX module's Python path): start at the
        finish word's exit if it is alive at T-1, else the best exit."""
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
        out = []
        for s in segs:
            wid = self.dict.wordid(s.word)
            if wid < 0 or self.dict.is_filler(wid):
                continue
            out.append(self.dict.basestr(wid))
        return " ".join(out), segs
