"""FSG decoding: dense Viterbi over grammar arcs (src/fsg_search.c,
fsg_lextree.c, fsg_history.c re-design).

Port of `pocketsphinx_tpu.search.fsg`.  The host network build
(`__init__`'s grammar edits, `_build`) and `_backtrace` are NumPy copies;
the per-frame step is torch on the search's device (CUDA unless
`device="cpu"`), its frames run as 16-frame chunks captured once as a
CUDA graph and replayed (`base.ChunkGraph`) where the JAX package ran
one `lax.scan` (`graph=False`: one Python call per frame).  The records
stay on the device until the utterance ends and are copied to the host
once.

Every word-labeled grammar arc owns a dense HMM chain (word-instance-per-
arc, like the reference's per-FSG-state lextrees but flattened to
arrays).  Epsilon transitions are folded into a static best-path closure
matrix, so one [A, A] max-plus product per frame implements all state
traversal: entry(b) = max_a exit_a(class f0(b)) + closure[dst(a), src(b)]
+ logprob(b) + wip + pip (the pnode logs2prob composition of
src/fsg_lextree.c:428-430); the source of each entry is the first
maximum over the source axis.

Silence/filler self-loops (fsg_search_add_silences, src/fsg_search.c:
87-145) and alternate pronunciations (add_altpron :147-170) are applied
to the grammar before compilation: `__init__` edits the grammar it is
given, as the JAX search does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..lm.fsg import FsgModel
from ..models.acoustic import AcousticModel, UNIT_NATS
from ..models.chains import ChainRows, append_word_chain
from ..models.dict2pid import Dict2Pid
from ..ops.hmm import hmm_step, out_meta, propagate_meta
from .base import DeviceSearch, host_to
from .ngram_fused import Seg

NEG_INF = -1e30
SHIFT = 1 << 10


class FsgDecoder(DeviceSearch):
    def __init__(self, am: AcousticModel, d2p: Dict2Pid, fsg: FsgModel,
                 wip: float = 0.65, pip: float = 1.0,
                 silprob: float = 0.005, fillprob: float = 1e-8,
                 use_filler: bool = True, use_altpron: bool = True,
                 device=None, graph: bool = True):
        self.device = resolve_device(device)
        self.graph = graph
        self.am = am
        self.d2p = d2p
        self.dict = d2p.dict
        self.mdef = am.mdef
        self.fsg = fsg
        ln = lambda p: math.log(p) / UNIT_NATS  # noqa: E731
        # the FSG search scales wip/pip by lw, unlike the n-gram search
        # (fsg_search.c:208-217: logmath_log(wip) * lw >> SENSCR_SHIFT)
        self.wip = ln(wip) * fsg.lw
        self.pip = ln(pip) * fsg.lw
        if use_filler:
            # add <sil> everywhere plus the other filler-dictionary words
            fsg.add_silence("<sil>", -1, silprob)
            for wid in range(len(self.dict)):
                if (self.dict.filler[wid]
                        and wid not in (self.dict.silwid,
                                        self.dict.startwid,
                                        self.dict.finishwid)):
                    fsg.add_silence(self.dict.wordstr(wid), -1, fillprob)
        if use_altpron:
            for w in list(fsg.vocab):
                wid = self.dict.wordid(w)
                if wid < 0:
                    continue
                for alt in self.dict.alternates(wid):
                    astr = self.dict.wordstr(alt)
                    if astr != self.dict._norm(w):
                        fsg.add_alt(w, astr)
        self._records = None
        self.rebuild()

    def _build(self):
        d, mdef, d2p, fsg = self.dict, self.mdef, self.d2p, self.fsg
        sil = mdef.sil
        arcs = []            # (link, dict wid)
        for l in fsg.links:
            if l.wid < 0:
                continue
            wid = d.wordid(fsg.vocab[l.wid])
            if wid < 0:
                continue     # word not in dictionary: arc unusable
            arcs.append((l, wid))
        if not arcs:
            raise ValueError("FSG has no decodable word transitions")
        self.arcs = arcs
        A = len(arcs)
        self.A = A
        # lattice-builder interface: per-"word" (arc) dict wid
        self.words = [wid for _, wid in arcs]
        self.start_idx = None

        rows = ChainRows()
        first_node = np.zeros(A, np.int32)
        final_base = np.zeros(A, np.int32)
        cls_map = np.zeros((A, mdef.n_ciphone), np.int16)
        f0_arr = np.zeros(A, np.int32)
        for i, (l, wid) in enumerate(arcs):
            f0_arr[i] = int(d.pron(wid)[0])
            fn, fb, nc, cr = append_word_chain(rows, d, mdef, d2p, wid, i,
                                               mdef.n_ciphone)
            first_node[i] = fn
            final_base[i] = fb
            cls_map[i] = cr

        self.P = len(rows.senid)
        self.senid = np.asarray(rows.senid, np.int32)
        tpc = self.am.tmat.tp[np.asarray(rows.tmat)].astype(np.float32)
        self.tp = np.where(tpc == 255, NEG_INF, -tpc)
        self.chain_pred = np.asarray(rows.chain_pred, np.int32)
        self.node_arc = np.asarray(rows.owner, np.int32)
        self.first_node = first_node
        # exit node per (arc a, next arc b): class of b's first phone
        self.exit_node = (final_base[:, None]
                          + cls_map[np.arange(A)[:, None],
                                    f0_arr[None, :]].astype(np.int32))
        self.exit_node_sil = (final_base
                              + cls_map[np.arange(A), sil].astype(np.int32))

        # arc-to-arc transition matrix via null closure (shifted units)
        C = fsg.null_closure() / SHIFT
        lp = np.array([l.logprob for l, _ in arcs]) / SHIFT
        dsts = np.array([l.dst for l, _ in arcs])
        srcs = np.array([l.src for l, _ in arcs])
        self.M = (C[dsts[:, None], srcs[None, :]]
                  + lp[None, :] + self.wip + self.pip).astype(np.float32)
        # entry from the start state; exit reach to the final state
        self.start_entry = (C[fsg.start_state, srcs] + lp
                            + self.wip + self.pip).astype(np.float32)
        self.final_reach = C[dsts, fsg.final_state].astype(np.float32)

    def _device_tables(self, device) -> dict:
        t = host_to(device)
        entry_nodes = np.nonzero(self.chain_pred < 0)[0]
        return dict(
            senid=t(self.senid.reshape(-1).astype(np.int64)),
            tp=t(self.tp),
            chain_pred=t(np.maximum(self.chain_pred, 0).astype(np.int64)),
            has_pred=t(self.chain_pred >= 0),
            en=t(entry_nodes.astype(np.int64)),
            ea=t(self.node_arc[entry_nodes].astype(np.int64)),
            exit_node=t(self.exit_node.astype(np.int64)),
            exit_node_sil=t(self.exit_node_sil.astype(np.int64)),
            M=t(self.M), final_reach=t(self.final_reach))

    # -- decode --------------------------------------------------------------

    def initial_carry(self):
        """(S, STF, PRA, ENTV) [P, NST] at frame 0 on the device: every
        arc leaving the start state entered at its first node."""
        NST = self.mdef.n_emit_state
        S0 = np.full((self.P, NST), NEG_INF, np.float32)
        entry_nodes = np.nonzero(self.chain_pred < 0)[0]
        entry_arcs = self.node_arc[entry_nodes]
        for k, node in enumerate(entry_nodes):
            a = entry_arcs[k]
            if np.isfinite(self.start_entry[a]):
                S0[node, 0] = self.start_entry[a]
        t = host_to(self.device)
        return (t(S0), t(np.zeros((self.P, NST), np.int32)),
                t(np.full((self.P, NST), -1, np.int32)),
                t(np.zeros((self.P, NST), np.float32)))

    def step(self, carry, sen_t, t):
        """One frame: carry (S, STF, PRA, ENTV) [P, NST], sen_t [P, NST]
        senone goodness, t the frame index.  Returns (new carry, records
        (escore, estf, epra, eascr [A], final_score []))."""
        tb = self.tables
        S, STF, PRA, ENTV = carry
        pip = float(np.float32(self.pip))
        newS, srcm, out, out_src = hmm_step(S, sen_t, tb["tp"])
        out_stf = out_meta(STF, out_src)
        out_pra = out_meta(PRA, out_src)
        out_entv = out_meta(ENTV, out_src)
        newSTF = propagate_meta(STF, srcm)
        newPRA = propagate_meta(PRA, srcm)
        newENTV = propagate_meta(ENTV, srcm)
        # the step's fresh tensors take the entries in place
        cp = tb["chain_pred"]
        chain_entry = torch.where(tb["has_pred"], out[cp] + pip, NEG_INF)
        ch_win = chain_entry > newS[:, 0]
        newS[:, 0] = torch.where(ch_win, chain_entry, newS[:, 0])
        newSTF[:, 0] = torch.where(ch_win, out_stf[cp], newSTF[:, 0])
        newPRA[:, 0] = torch.where(ch_win, out_pra[cp], newPRA[:, 0])
        newENTV[:, 0] = torch.where(ch_win, out_entv[cp], newENTV[:, 0])

        xs = tb["exit_node_sil"]
        exg = out[tb["exit_node"]]                     # [A, A]
        escore = out[xs]
        estf = out_stf[xs]
        epra = out_pra[xs]
        eascr = escore - out_entv[xs]
        trans = exg + tb["M"]
        entry, ent_src = torch.max(trans, dim=0)       # first max: source
        en, ea = tb["en"], tb["ea"]
        cur0 = newS[en, 0]
        e_here = entry[ea]
        ewin = e_here > cur0
        newS[en, 0] = torch.where(ewin, e_here, cur0)
        newSTF[en, 0] = torch.where(ewin, t + 1, newSTF[en, 0])
        newPRA[en, 0] = torch.where(ewin, ent_src[ea].to(torch.int32),
                                    newPRA[en, 0])
        newENTV[en, 0] = torch.where(ewin, e_here, newENTV[en, 0])
        m = newS.max()
        newS -= m
        newENTV -= m
        final_score = (escore + tb["final_reach"]).max()
        return (newS, newSTF, newPRA, newENTV), (escore, estf, epra, eascr,
                                                 final_score)

    def decode(self, feats, costs=None):
        """Decode one utterance (feats [T, F, L], or its senone costs
        [T, n_sen]); returns (hyp, segs).  `records` holds the host copy
        of the per-frame records (escore, estf, epra, eascr [T, A],
        final_score [T])."""
        costs = self.utterance_costs(feats, costs)
        T = costs.shape[0]
        NST = self.mdef.n_emit_state
        sen = -costs[:, self.tables["senid"]].reshape(T, self.P, NST)
        self._dev_records, self._records = self._scan(
            self.step, self.initial_carry(), (sen,), T)
        return self._backtrace(self._records, T)

    @property
    def records(self):
        return self._records

    def lattice_inputs(self):
        """What the lattice's exit scan reads: (escore, estf [T, A] on the
        device, ascr_at(t, a) the host eascr of exits (t, a))."""
        escore, estf = self._dev_records[:2]
        eascr = self._records[3]
        return escore, estf, lambda t, w: eascr[t, w]

    def _backtrace(self, recs, T):
        escore, estf, epra = [np.asarray(r) for r in recs[:3]]
        # best arc whose exit reaches the final state at the last frame
        reach = escore[T - 1] + self.final_reach
        a = int(np.argmax(reach))
        if not np.isfinite(reach[a]) or reach[a] < NEG_INF / 2:
            a = int(np.argmax(escore[T - 1]))
        segs = []
        t = T - 1
        while t >= 0 and a >= 0:
            wid = self.arcs[a][1]
            s = int(estf[t, a])
            segs.append(Seg(word=self.dict.wordstr(wid), start=s, end=t))
            p = int(epra[t, a])
            if s <= 0 or p < 0:
                break
            a = p
            t = s - 1
        segs.reverse()
        out = []
        for s in segs:
            wid = self.dict.wordid(s.word)
            if wid < 0 or self.dict.is_filler(wid):
                continue
            out.append(self.dict.basestr(wid))
        return " ".join(out), segs
