"""Forced alignment: dense time-synchronous Viterbi over a phone graph.

Port of `pocketsphinx_tpu.search.align`.  The graph build
(`build_graph`), `_backtrace` and `_emit_entries` are host code, copied;
the per-frame step is torch on the aligner's device (CUDA unless
`device="cpu"`), and its compact per-frame backpointer records (int8 /
uint8 / bool) are copied to the host once per utterance.

The reference's alignment path (`pocketsphinx align`: ps_set_align_text
-> linear word FSG with optional silences and alternate pronunciations
-> fsg_search, src/pocketsphinx.c:681-731, src/fsg_search.c:87-200;
state-level semantics as src/state_align_search.c) becomes a dense state
tensor [P, NST] (P = phones in the graph) stepped every frame, dense
per-frame backpointer codes, and an argmax backtrace on the host -- no
pruning, fixed topology.

Graph shape: for each word, all alternate pronunciations as parallel
phone chains; an optional (skippable) silence phone between words and at
both edges.  Each phone row carries a padded predecessor list, so the
cross-phone entry step is one gather + first-max.

HMM semantics replicated from hmm_vit_eval (src/hmm.c:222-350):
emissions attach to the *source* state of each transition; the
non-emitting exit is computed from pre-update scores; entry into a
phone happens after evaluation and takes effect the next frame.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..models.acoustic import AcousticModel, UNIT_NATS
from ..models.dict2pid import Dict2Pid
from ..ops.hmm import hmm_step
from .base import DeviceSearch, host_to

NEG_INF = -1e30
MAX_PREDS = 8


@dataclass
class AlignEntry:
    text: str
    start: int          # frame
    duration: int       # frames
    score: float        # acoustic path score (shifted logmath units)
    level: str          # "word" | "phone" | "state"
    parent: int = -1
    senid: int = -1
    wid: int = -1


@dataclass
class PhoneNode:
    ci: int
    ssid: int
    tmat: int
    word_pos: int       # index into the word sequence, -1 for silence
    wid: int            # dictionary wid (the alternate actually used)
    preds: list = field(default_factory=list)   # (phone idx, penalty)
    is_sil: bool = False
    is_start: bool = False
    start_pen: float = 0.0


class Aligner(DeviceSearch):
    """Forced aligner over a fixed word sequence (with alternate
    pronunciations and optional inter-word silences)."""

    def __init__(self, am: AcousticModel, d2p: Dict2Pid,
                 silprob: float = 0.005, wip: float = 0.65, lw: float = 6.5,
                 use_silence: bool = True, use_altpron: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.am = am
        self.d2p = d2p
        self.dict = d2p.dict
        self.mdef = am.mdef
        self.log_silprob = math.log(silprob) * lw / UNIT_NATS
        self.log_wip = math.log(wip) * lw / UNIT_NATS
        self.use_silence = use_silence
        self.use_altpron = use_altpron

    def rebuild(self):
        """Nothing: the graph is built from the dictionary at each
        `align` (the JAX aligner has no `_build`)."""

    # -- graph construction --------------------------------------------------

    def build_graph(self, words: list[str]) -> list[PhoneNode]:
        """Words -> phone graph with cross-word triphone context variants.

        Like fsg_lextree (src/fsg_lextree.c), word-*initial* phones are
        replicated per distinct actual left context (a previous word
        alternate's final phone, or SIL after optional silence) and
        word-*final* phones per distinct right context (next word
        alternates' first phones, or SIL) — each variant connecting only
        to the matching neighbor.  Fillers map to SIL inside the context
        tables (bin_mdef_phone_id, src/bin_mdef.c:762-768).

        The boundary "frontier" between word i and i+1 is a list of
        (node, presented_lc, required_rc) tuples: `presented_lc` is the
        CI phone the next word sees as its left context; `required_rc`
        constrains which next first-phones may connect (None = any,
        used for silence)."""
        d, mdef, d2p = self.dict, self.mdef, self.d2p
        base_wids = []
        for w in words:
            wid = d.wordid(w)
            if wid < 0:
                raise KeyError(f"Unknown word {w!r}")
            base_wids.append(wid)
        sil = mdef.sil
        nodes: list[PhoneNode] = []

        def alts_of(i):
            return (list(self.dict.alternates(base_wids[i]))
                    if self.use_altpron else [base_wids[i]])

        def add_sil(preds):
            n = PhoneNode(ci=sil, ssid=int(mdef.phone_ssid[sil]),
                          tmat=int(mdef.phone_tmat[sil]), word_pos=-1,
                          wid=d.silwid, is_sil=True)
            n.preds = [(p, self.log_silprob + self.log_wip) for p in preds]
            nodes.append(n)
            return len(nodes) - 1

        # frontier tuples: (node_idx, presented_lc, required_rc|None)
        frontier: list[tuple] = []
        start_lcs = {sil}           # lc values valid for utterance start
        if self.use_silence:
            s0 = add_sil([])
            nodes[s0].is_start = True
            nodes[s0].start_pen = self.log_silprob + self.log_wip
            frontier.append((s0, sil, None))

        first_word = True
        for i in range(len(base_wids)):
            alts = alts_of(i)
            # distinct right contexts after this word
            if i + 1 < len(base_wids):
                rcs = {int(d.pron(a)[0]) for a in alts_of(i + 1)}
            else:
                rcs = set()
            if self.use_silence or i + 1 >= len(base_wids):
                rcs.add(sil)
            rcs = sorted(rcs)
            new_frontier: list[tuple] = []
            for wid in alts:
                pron = [int(x) for x in d.pron(wid)]
                L = len(pron)
                f0 = pron[0]
                # predecessors eligible to connect into this alternate
                elig = [(idx, lc) for idx, lc, req in frontier
                        if req is None or req == f0]
                lcs = sorted({lc for _, lc in elig})
                if first_word:
                    lcs = sorted(set(lcs) | start_lcs)
                if L == 1:
                    for lc in lcs:
                        for rc in rcs:
                            ssid = int(d2p.lrdiph_rc[f0, lc, rc])
                            n = PhoneNode(ci=f0, ssid=ssid,
                                          tmat=int(mdef.phone_tmat[f0]),
                                          word_pos=i, wid=wid)
                            n.preds = [(idx, self.log_wip)
                                       for idx, plc in elig if plc == lc]
                            if first_word and lc == sil:
                                n.is_start = True
                                n.start_pen = self.log_wip
                            nodes.append(n)
                            new_frontier.append((len(nodes) - 1, f0, rc))
                    continue
                # first phone: one variant per distinct left context
                first_nodes = []
                for lc in lcs:
                    ssid = int(d2p.ldiph_lc[f0, pron[1], lc])
                    n = PhoneNode(ci=f0, ssid=ssid,
                                  tmat=int(mdef.phone_tmat[f0]),
                                  word_pos=i, wid=wid)
                    n.preds = [(idx, self.log_wip)
                               for idx, plc in elig if plc == lc]
                    if first_word and lc == sil:
                        n.is_start = True
                        n.start_pen = self.log_wip
                    nodes.append(n)
                    first_nodes.append(len(nodes) - 1)
                # internal phones: single chain fed by all first variants
                prev = first_nodes
                internal = d2p.internal_ssids(wid)
                for j in range(1, L - 1):
                    ci = pron[j]
                    n = PhoneNode(ci=ci, ssid=int(internal[j - 1]),
                                  tmat=int(mdef.phone_tmat[ci]),
                                  word_pos=i, wid=wid)
                    n.preds = [(p, 0.0) for p in prev]
                    nodes.append(n)
                    prev = [len(nodes) - 1]
                # final phone: one variant per distinct right context
                uniq, cimap = d2p.rssid(pron[-1], pron[-2])
                for rc in rcs:
                    ssid = int(uniq[cimap[rc]])
                    n = PhoneNode(ci=pron[-1], ssid=ssid,
                                  tmat=int(mdef.phone_tmat[pron[-1]]),
                                  word_pos=i, wid=wid)
                    n.preds = [(p, 0.0) for p in prev]
                    nodes.append(n)
                    new_frontier.append((len(nodes) - 1, pron[-1], rc))
            first_word = False
            # optional silence fed by rc == SIL final variants
            frontier = [t for t in new_frontier if t[2] != sil]
            sil_feed = [idx for idx, _, rc in new_frontier if rc == sil]
            if self.use_silence and sil_feed:
                s = add_sil(sil_feed)
                frontier.append((s, sil, None))
            self._ending = [idx for idx, _, rc in new_frontier if rc == sil]
            if self.use_silence and sil_feed:
                self._ending = self._ending + [s]
        self._final_frontier = self._ending if getattr(self, "_ending", None) \
            else [len(nodes) - 1]
        return nodes

    # -- dense Viterbi -------------------------------------------------------

    def graph_tables(self, nodes):
        """Host arrays of a graph: senid [P, NST], tp [P, NST, NST+1],
        preds [P, MAX_PREDS] and their penalties (NEG_INF pads)."""
        P = len(nodes)
        senid = np.array([self.mdef.sseq[n.ssid] for n in nodes],
                         dtype=np.int32)
        tpc = self.am.tmat.tp[[n.tmat for n in nodes]].astype(np.float32)
        tp = np.where(tpc == 255, NEG_INF, -tpc)              # goodness
        preds = np.zeros((P, MAX_PREDS), dtype=np.int32)
        pred_pen = np.full((P, MAX_PREDS), NEG_INF, dtype=np.float32)
        for pi, n in enumerate(nodes):
            if len(n.preds) > MAX_PREDS:
                raise ValueError("too many predecessors; raise MAX_PREDS")
            for k, (pp, pen) in enumerate(n.preds):
                preds[pi, k] = pp
                pred_pen[pi, k] = pen
        return senid, tp, preds, pred_pen

    @staticmethod
    def step(S, sen_t, tp, preds, pen):
        """One frame: S [P, NST], sen_t [P, NST] senone goodness, the
        graph's tp, preds and penalties on the device.  Returns (new S,
        records (state sources int8 [P, NST], exit source int8, entry won
        bool, entry's predecessor slot uint8, exit score less the renorm
        [P]))."""
        newS, srcm, out, out_src = hmm_step(S, sen_t, tp)
        # entry: max over predecessor exits + edge penalty (first max)
        evals = out[preds] + pen                               # [P, K]
        entry, esrc = torch.max(evals, dim=-1)
        ewin = entry > newS[:, 0]
        newS[:, 0] = torch.where(ewin, entry, newS[:, 0])
        m = newS.max()
        return newS - m, (srcm.to(torch.int8), out_src.to(torch.int8),
                          ewin, esrc.to(torch.uint8), out - m)

    def align(self, feats: np.ndarray, words: list[str],
              costs: np.ndarray | None = None):
        """feats [T, F, L] -> (word, phone, state) AlignEntry lists.

        Senone scoring and the frame steps run on the device; the
        backtrace on the host.  ``costs`` may be precomputed [T, n_sen]
        senone costs."""
        nodes = self.build_graph(words)
        P = len(nodes)
        NST = self.mdef.n_emit_state
        senid, tp, preds, pred_pen = self.graph_tables(nodes)
        costs = self.utterance_costs(feats, costs)
        T = costs.shape[0]
        t = host_to(self.device)
        sen = -costs[:, t(senid.reshape(-1).astype(np.int64))].reshape(
            T, P, NST)
        tp_d, preds_d, pen_d = t(tp), t(preds.astype(np.int64)), t(pred_pen)
        S0 = np.full((P, NST), NEG_INF, np.float32)
        for pi, n in enumerate(nodes):
            if n.is_start:
                S0[pi, 0] = n.start_pen
        #: the last alignment's records (SRC, OSRC, EWIN, ESRC, OUT)
        _, self.records = self._run(
            lambda S, sen_t, _t: self.step(S, sen_t, tp_d, preds_d, pen_d),
            t(S0), (sen,), T)
        return self._backtrace(words, nodes, sen.cpu().numpy(),
                               *self.records, preds)

    def _backtrace(self, words, nodes, sen, SRC, OSRC, EWIN, ESRC, OUT,
                   preds):
        T, P, _ = sen.shape
        best_p = max(self._final_frontier, key=lambda c: OUT[T - 1, c])
        p = best_p
        jcur = int(OSRC[T - 1, p])         # source state of the final exit
        emitted = np.zeros((T, 2), dtype=np.int32)
        t = T - 1
        while t >= 0:
            emitted[t] = (p, jcur)
            src = int(SRC[t, p, jcur])
            if src == 0 and t > 0 and EWIN[t - 1, p]:
                # entered at end of frame t-1 from a predecessor's exit
                p = int(preds[p, ESRC[t - 1, p]])
                jcur = int(OSRC[t - 1, p])
            else:
                jcur = src
            t -= 1
        return self._emit_entries(words, nodes, emitted, sen, T)

    def _emit_entries(self, words, nodes, emitted, sen, T):
        """Group the per-frame (phone, state) chain into state/phone/word
        entries."""
        states: list[AlignEntry] = []
        for t in range(T):
            p, j = emitted[t]
            sid = int(self.mdef.sseq[nodes[p].ssid][j])
            if states and states[-1].parent == p and states[-1].senid == sid:
                states[-1].duration += 1
                states[-1].score += float(sen[t, p, j])
            else:
                states.append(AlignEntry(
                    text=f"state{j}", start=t, duration=1,
                    score=float(sen[t, p, j]), level="state", parent=int(p),
                    senid=sid))
        phones_out: list[AlignEntry] = []
        last_p = None
        for st in states:
            p = st.parent
            if phones_out and last_p == p:
                phones_out[-1].duration = (st.start + st.duration
                                           - phones_out[-1].start)
                phones_out[-1].score += st.score
            else:
                phones_out.append(AlignEntry(
                    text=self.mdef.ciname[nodes[p].ci], start=st.start,
                    duration=st.duration, score=st.score, level="phone",
                    parent=p, wid=nodes[p].wid))
                last_p = p
        words_out: list[AlignEntry] = []
        last_key = None
        for k, ph in enumerate(phones_out):
            n = nodes[ph.parent]
            w = n.word_pos
            text = "<sil>" if w < 0 else self.dict.wordstr(n.wid)
            key = ("sil", ph.parent) if w < 0 else ("w", w)
            if words_out and last_key == key:
                words_out[-1].duration = (ph.start + ph.duration
                                          - words_out[-1].start)
                words_out[-1].score += ph.score
            else:
                words_out.append(AlignEntry(
                    text=text, start=ph.start, duration=ph.duration,
                    score=ph.score, level="word", parent=w, wid=n.wid))
                last_key = key
            ph.parent = len(words_out) - 1
        # link states to phone indices
        pidx = -1
        last_p = None
        for st in states:
            if last_p != st.parent:
                pidx += 1
                last_p = st.parent
            st.parent = pidx
        return words_out, phones_out, states
