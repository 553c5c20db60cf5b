"""Word lattices: DAG construction, best-path rescoring, posteriors,
A* N-best (src/ps_lattice.c re-design).

Port of `pocketsphinx_tpu.search.lattice`.  Construction finds the
plausible word exits on the decoder's device (`plausible_exits`: the
per-frame best, the beam and liveness masks, the start-frame check and
the survivors in (t, w) order) and builds the node and link lists from
the survivors with vectorized host code; the lists, and so every result
below, equal the JAX package's (which builds them in its C extension).
Everything after construction is the JAX module's host code.

The lattice is built from the flat decoder's dense per-frame records
(the backpointer-table equivalent): every plausible word exit (t, w)
becomes a node keyed (word, start frame); links connect nodes whose
spans abut, carrying the pred-independent segment acoustic score that
the decoder's ENTV channel makes exact.  On this DAG:

  * bestpath:  forward link DP with LM rescoring at bestpathlw/lw ratio
               (ps_lattice_bestpath, src/ps_lattice.c:1216-1440)
  * posterior: forward-backward alpha/beta over links with 1/ascale
               acoustic scaling (ps_lattice_posterior :1448-1524)
  * nbest:     A* over links with best-remaining-score heuristic
               (ps_astar_* :1714-1850)
  * write_htk: HTK SLF output (ps_lattice_write_htk :271)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

SHIFT = 1 << 10
NEG_INF = -1e30
LN_BASE_SHIFTED = math.log(1.0001) * SHIFT  # nats per shifted unit


@dataclass
class LatNode:
    word: str           # word string (with alt suffix)
    base: str           # base word (for LM)
    sf: int             # start frame
    is_fill: bool
    id: int = -1
    entries: list = field(default_factory=list)   # incoming link ids
    exits: list = field(default_factory=list)     # outgoing link ids


@dataclass
class LatLink:
    src: int            # node id
    dst: int
    ef: int             # end frame of src's word (dst.sf - 1)
    ascr: float         # segment acoustic score (shifted units)
    lscr: float = 0.0   # LM score filled by bestpath
    alpha: float = NEG_INF
    beta: float = NEG_INF
    post: float = NEG_INF


def plausible_exits(escore, estf, thresh: float, device):
    """The plausible word exits of records escore/estf [T, W], on
    `device`: exits within `thresh` (shifted units, < 0) of their frame's
    best and alive (> NEG_INF/2), whose start frame sf obeys 0 <= sf <= t.
    Returns host arrays (t, w, sf) of the survivors in (t, w) order."""
    es = torch.as_tensor(escore, device=device)
    sf = torch.as_tensor(estf, device=device)
    T = es.shape[0]
    best = torch.clamp(es.amax(dim=1, keepdim=True), min=NEG_INF)
    # float32 arithmetic, the threshold rounded to float32 first
    ok = ((es >= best + float(np.float32(thresh)))
          & (es >= float(np.float32(NEG_INF / 2)))
          & (sf >= 0)
          & (sf <= torch.arange(T, device=es.device)[:, None]))
    tw = torch.nonzero(ok)                          # (t, w) row-major
    sfv = sf[tw[:, 0], tw[:, 1]]
    tw, sfv = tw.cpu().numpy(), sfv.cpu().numpy()
    return tw[:, 0], tw[:, 1], sfv.astype(np.int64)


def _number_nodes(t, w, sf, T):
    """Node ids of the exits' (w, sf) keys by first appearance in the
    exits' order: (node word [n], node start frame [n], node of each
    exit)."""
    key = w.astype(np.int64) * T + sf
    uniq, first, inv = np.unique(key, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    return w[first[order]], sf[first[order]], rank[inv.reshape(-1)]


def _links(t, a, exit_node, node_sf, T):
    """Every exit at t < T-1 to every node starting at t+1, in the order
    (exit, destination node id): (src, dst, ef, ascr) arrays."""
    by_sf = np.argsort(node_sf, kind="stable")      # by sf, then id
    cnt = np.bincount(node_sf, minlength=T + 1)
    off = np.concatenate([[0], np.cumsum(cnt)])
    nxt = np.minimum(t + 1, T)                      # cnt[T] == 0
    n = np.where(t + 1 < T, cnt[nxt], 0)
    tot = int(n.sum())
    within = np.arange(tot) - np.repeat(np.cumsum(n) - n, n)
    dst = by_sf[np.repeat(off[nxt], n) + within]
    return (np.repeat(exit_node, n), dst, np.repeat(t, n),
            np.repeat(a.astype(np.float32), n))


class Lattice:
    def __init__(self, frate: int = 100):
        self.nodes: list[LatNode] = []
        self.links: list[LatLink] = []
        self.start: int = -1
        self.end: int = -1
        self.frate = frate
        self.n_frames = 0
        self.norm = NEG_INF
        # acoustic score of the implicit link exiting the final node
        # (ps_lattice_internal.h:85); stays 0 when terminal links carry
        # the last word's segment score (from_flat_records) or when the
        # DAG was read from a file (ps_lattice_read leaves it 0 too)
        self.final_node_ascr = 0.0

    # -- construction --------------------------------------------------------

    @classmethod
    def from_flat_records(cls, dec, beam: float = 1e-5,
                          records=None) -> "Lattice":
        """Build from an `NgramFusedDecoder` or an `FsgDecoder` (whose
        "words" are its grammar arcs) after a decode: from its current
        records (`dec.lattice_inputs`: after `decode`, the records on its
        device), or from flat records = (escore, estf,
        eprw, eascr, ...) [T, W] passed explicitly (batch decodes).  The
        exit scan runs on the decoder's device; only the surviving exits
        reach the host.

        Nodes are the (word, start frame) pairs of the plausible exits,
        numbered by first appearance in (t, w) order.  Every exit at t <
        T-1 links to every node starting at t+1 (links in the order t,
        the frame's exits by w, destination nodes by id); the exits at
        T-1 link to a terminal node."""
        if records is None:
            escore, estf, ascr_at = dec.lattice_inputs()
        else:
            escore, estf = records[0], records[1]
            ascr_at = lambda t, w: np.asarray(records[3])[t, w]  # noqa: E731
        T = escore.shape[0]
        lat = cls()
        lat.n_frames = T
        thresh = math.log(beam) / LN_BASE_SHIFTED  # shifted units (<0)
        d = dec.dict
        words = dec.words
        t, w, sf = plausible_exits(escore, estf, thresh, dec.device)
        a = ascr_at(t, w)
        node_w, node_sf, exit_node = _number_nodes(t, w, sf, T)
        src, dst, ef, la = _links(t, a, exit_node, node_sf, T)
        for i, (wi, s_) in enumerate(zip(node_w.tolist(), node_sf.tolist())):
            wid = words[wi]
            lat.nodes.append(LatNode(
                word=d.wordstr(wid), base=d.basestr(wid), sf=s_,
                is_fill=d.is_filler(wid), id=i))
        for lid, (s_, d_, e_, a_) in enumerate(zip(
                src.tolist(), dst.tolist(), ef.tolist(), la.tolist())):
            lat.links.append(LatLink(src=s_, dst=d_, ef=e_, ascr=a_))
            lat.nodes[s_].exits.append(lid)
            lat.nodes[d_].entries.append(lid)
        # final-frame exits for the terminal pass below
        last = t == T - 1
        ends_last = list(zip(exit_node[last].tolist(), a[last].tolist()))
        # start node: the decoder's start word instance at frame 0 if
        # present, else any node at sf == 0
        start_word = None
        if getattr(dec, "start_idx", None) is not None:
            start_word = d.wordstr(words[dec.start_idx])
        for nid, n in enumerate(lat.nodes):
            if n.sf == 0 and (start_word is None or n.word == start_word):
                lat.start = nid
                break
        if lat.start < 0:
            for nid, n in enumerate(lat.nodes):
                if n.sf == 0:
                    lat.start = nid
                    break
        # end node: best exit at final frame; add a terminal node
        term = LatNode(word="", base="", sf=T, is_fill=True,
                       id=len(lat.nodes))
        lat.nodes.append(term)
        lat.end = term.id
        for nid, ascr in ends_last:
            lid = len(lat.links)
            lat.links.append(LatLink(src=nid, dst=term.id, ef=T - 1,
                                     ascr=ascr))
            lat.nodes[nid].exits.append(lid)
            term.entries.append(lid)
        return lat

    @property
    def n_nodes(self):
        return len(self.nodes)

    @property
    def n_links(self):
        return len(self.links)

    # -- traversal order -----------------------------------------------------

    def _topo_links(self) -> list[int]:
        """Links ordered by end frame (a topological order since every
        link spans forward in time)."""
        return sorted(range(len(self.links)),
                      key=lambda i: self.links[i].ef)

    # -- bestpath (3rd pass) -------------------------------------------------

    @staticmethod
    def _lat_fil(n: LatNode) -> bool:
        """The lattice layer's filler test = dict_filler_word
        (src/dict.c:417-428): filler-dictionary words EXCEPT <s> and
        </s>, which are *real words* here — a mid-utterance <s> must
        pay its (essentially -inf) LM probability rather than pass
        free, or its paths soak up posterior mass the reference
        assigns ~0."""
        return n.is_fill and n.base not in ("<s>", "</s>")

    def _real_from_wid(self, li: int, back: np.ndarray, lm) -> int:
        """LM word id of link li's source, walking the best_prev chain
        past fillers to the nearest real predecessor word — the
        filler-skip walk of ps_lattice_bestpath/posterior
        (src/ps_lattice.c:1274-1284, :1496-1506).  Returns -1 when no
        real predecessor exists (history unusable)."""
        n = self.nodes[self.links[li].src]
        if not self._lat_fil(n) or self.links[li].src == self.start:
            return lm.wid(n.base) if n.base else -1
        p = li
        while back[p] >= 0:
            p = int(back[p])
            n = self.nodes[self.links[p].src]
            if not self._lat_fil(n) or self.links[p].src == self.start:
                return lm.wid(n.base) if n.base else -1
        return -1

    def _link_bprob(self, li: int, back: np.ndarray, lm) -> float:
        """Unweighted LM log prob (nats) of link li's destination word
        given the nearest real source word — ngram_ng_prob as used for
        the lattice alphas/betas (src/ps_lattice.c:1286-1291,
        :1496-1499).  The end node is never treated as a filler
        (matching the `to != dag->end` exemptions)."""
        if lm is None:
            return 0.0
        l = self.links[li]
        to = self.nodes[l.dst]
        if (self._lat_fil(to) and l.dst != self.end) or not to.base:
            return 0.0
        w2 = lm.wid(to.base)
        if w2 < 0:
            return 0.0
        w3 = self._real_from_wid(li, back, lm)
        return lm.raw_score(w2, [w3] if w3 >= 0 else []) \
            * LN_BASE_SHIFTED / SHIFT

    def bestpath(self, lm=None, lwf: float = 1.0, silpen: float = 0.0,
                 fillpen: float = 0.0, finish_word: str | None = None,
                 ascale: float = 20.0):
        """Forward link DP with full LM rescoring (ps_lattice_bestpath,
        src/ps_lattice.c:1216-1440): start links get bg(to | <s>)
        (:1248); every relaxation applies tg(w1 | w3, w2) with w3/w2
        the nearest *real* predecessor words found by walking the DP's
        own best_prev chain past fillers (:1274-1309), degrading to
        bg(w1 | w2) when only partial context exists (:1326-1333).
        Fillers score silpen/fillpen (0 = reference behavior, where
        filler penalties live in the link ascr).  Also accumulates the
        forward log-sums (link alphas, with *unweighted* bigram
        probabilities per ngram_ng_prob) and the posterior normalizer
        used by posterior() (:1341-1380).

        Returns (best hyp string, [(word, sf, ef)], best score)."""
        L = len(self.links)
        order = self._topo_links()
        score = np.full(L, NEG_INF)
        back = np.full(L, -1, dtype=np.int64)
        alpha = np.full(L, NEG_INF)
        sc = LN_BASE_SHIFTED / ascale   # shifted units -> scaled nats

        def wid_of(node: LatNode) -> int:
            return lm.wid(node.base) if (lm is not None and node.base) \
                else -1

        def fil_pen(node: LatNode) -> float:
            return silpen if node.word == "<sil>" else fillpen

        def bg_prob(w: int, h: int) -> float:
            """Unweighted bigram log prob in nats (ngram_ng_prob)."""
            if lm is None or w < 0:
                return 0.0
            return lm.raw_score(w, [h] if h >= 0 else []) * LN_BASE_SHIFTED \
                / SHIFT

        # start links (:1239-1253)
        start_wid = wid_of(self.nodes[self.start])
        for li in self.nodes[self.start].exits:
            l = self.links[li]
            to = self.nodes[l.dst]
            to_fil = self._lat_fil(to) and l.dst != self.end
            score[li] = l.ascr
            if lm is not None and not to_fil:
                w = lm.wid(to.base)
                if w >= 0:
                    score[li] += lm.score(
                        w, [start_wid] if start_wid >= 0 else []) \
                        / SHIFT * lwf
            elif to_fil:
                score[li] += fil_pen(to)
            alpha[li] = 0.0

        def lse(a, b):
            if a <= NEG_INF / 2:
                return b
            if b <= NEG_INF / 2:
                return a
            m = max(a, b)
            return m + math.log1p(math.exp(min(a, b) - m))

        for li in order:
            if score[li] <= NEG_INF / 2:
                continue
            l = self.links[li]
            to = self.nodes[l.dst]
            # this link's acoustic score enters its alpha exactly once
            # (ps_lattice.c:1293); terminal links carry the final
            # node's segment score, so they get it too
            alpha[li] += l.ascr * sc
            if l.dst == self.end:
                continue
            # effective (w3, w2) real-word context after filler walks
            w3 = self._real_from_wid(li, back, lm) if lm is not None \
                else -1
            w2 = wid_of(to)
            w2_fil = self._lat_fil(to) and l.dst != self.end
            bprob = self._link_bprob(li, back, lm)
            if w2_fil:
                # LM context passes through the filler (:1297-1309)
                w2 = w3
                w3 = -1  # partial context only
            for xi in to.exits:
                x = self.links[xi]
                w1n = self.nodes[x.dst]
                w1 = wid_of(w1n)
                w1_fil = self._lat_fil(w1n) and x.dst != self.end
                alpha[xi] = lse(alpha[xi], alpha[li] + bprob)
                cand = score[li] + x.ascr
                if lm is not None and not w1_fil and w1 >= 0 \
                        and w2 >= 0:
                    hist = [w3, w2] if w3 >= 0 else [w2]
                    cand += lm.score(w1, hist) / SHIFT * lwf
                elif w1_fil:
                    cand += fil_pen(w1n)
                if cand > score[xi]:
                    score[xi] = cand
                    back[xi] = li
        # posterior normalizer: log-sum over links entering the final
        # node of alpha + P(end word | nearest real predecessor), plus
        # the final node's own acoustic score (ps_lattice.c:1341-1380;
        # final_node_ascr is 0 for our from_flat_records lattices,
        # whose terminal links carry the last word's segment score)
        norm = NEG_INF
        for li in self.nodes[self.end].entries:
            if alpha[li] > NEG_INF / 2:
                norm = lse(norm, alpha[li]
                           + self._link_bprob(li, back, lm))
        norm += self.final_node_ascr * sc
        self._alpha, self._back, self.norm = alpha, back, norm
        # cache the (lm, ascale) the forward pass used so posterior()
        # can detect mismatched reuse (ADVICE r2: mixing alphas and
        # betas computed under different scales corrupts posteriors)
        self._fwd_lm, self._fwd_ascale = lm, ascale
        for li, l in enumerate(self.links):
            l.alpha = alpha[li]

        # best terminal link; like ngram_search's find_exit, a final
        # </s> instance is preferred when one survives
        term_links = [li for li, l in enumerate(self.links)
                      if l.dst == self.end]
        if not term_links:
            return "", [], NEG_INF
        if finish_word is not None:
            fin = [li for li in term_links
                   if self.nodes[self.links[li].src].word == finish_word
                   and score[li] > NEG_INF / 2]
            if fin:
                term_links = fin
        best = max(term_links, key=lambda li: score[li])
        self._bestend = best
        chain = []
        li = best
        while li >= 0:
            chain.append(li)
            li = int(back[li])
        chain.reverse()
        self._best_chain = chain
        segs = []
        self._best_seg_scores = []     # (ascr, lscr) per seg
        prev_hist: list[int] = []
        for li in chain:
            l = self.links[li]
            n = self.nodes[l.src]
            segs.append((n.word, n.sf, l.ef))
            lscr = 0.0
            if lm is not None and not n.is_fill and n.base:
                w = lm.wid(n.base)
                if w >= 0:
                    lscr = lm.score(w, prev_hist[-2:]) / SHIFT * lwf
                    prev_hist.append(w)
            self._best_seg_scores.append((l.ascr, lscr))
        hyp = " ".join(self.nodes[self.links[li].src].base for li in chain
                       if not self.nodes[self.links[li].src].is_fill)
        return hyp, segs, float(score[best])

    # -- posteriors ----------------------------------------------------------

    def posterior(self, lm=None, ascale: float = 20.0):
        """Forward-backward over links; sets link.post (log posterior,
        nats) and returns the normalizer.  Acoustic scores scaled by
        1/ascale and each link weighted by the unweighted bigram
        probability of its destination word given the nearest real
        source word, exactly like ps_lattice_posterior
        (src/ps_lattice.c:1448-1524, bprob at :1496-1499 and the
        filler-skip walk at :1482-1493).  Runs bestpath's forward pass
        first when it hasn't run (the reference requires bestpath
        before posterior, src/ngram_search.c:828-837)."""
        if getattr(self, "_alpha", None) is None \
                or len(self._alpha) != len(self.links) \
                or getattr(self, "_fwd_lm", None) is not lm \
                or getattr(self, "_fwd_ascale", None) != ascale:
            self.bestpath(lm=lm, ascale=ascale)
        alpha, back = self._alpha, self._back
        order = self._topo_links()
        sc = LN_BASE_SHIFTED / ascale   # shifted units -> scaled nats

        def lse(a, b):
            if a <= NEG_INF / 2:
                return b
            if b <= NEG_INF / 2:
                return a
            m = max(a, b)
            return m + math.log1p(math.exp(min(a, b) - m))

        beta = np.full(len(self.links), NEG_INF)
        for li in reversed(order):
            l = self.links[li]
            to = self.nodes[l.dst]
            bprob = self._link_bprob(li, back, lm)
            if l.dst == self.end:
                # imaginary exit link from the final node has beta 1.0
                # (ps_lattice.c:1508-1510)
                beta[li] = bprob + self.final_node_ascr * sc
                continue
            total = NEG_INF
            for xi in to.exits:
                x = self.links[xi]
                total = lse(total, beta[xi] + bprob + x.ascr * sc)
            beta[li] = total
        norm = self.norm
        if norm <= NEG_INF / 2:
            norm = NEG_INF
            for li in self.nodes[self.end].entries:
                norm = lse(norm, alpha[li] + beta[li])
            self.norm = norm
        for li, l in enumerate(self.links):
            l.beta = beta[li]
            l.post = alpha[li] + beta[li] - norm
        # sentence posterior P(S|O) = joint of the best path minus the
        # normalizer (ps_lattice_joint, ps_get_prob semantics)
        self.post = norm
        be = getattr(self, "_bestend", -1)
        if be >= 0:
            jprob = self.final_node_ascr * sc
            li = be
            while li >= 0:
                l = self.links[li]
                jprob += l.ascr * sc + self._link_bprob(li, back, lm)
                li = int(back[li]) if back[li] >= 0 else -1
            self.post = jprob - norm
        return self.post

    def posterior_prune(self, beam: float, lm=None, ascale: float = 20.0):
        """Remove links whose posterior is more than `beam` (negative,
        nats) below the best, then drop unreachable nodes
        (ps_lattice_posterior_prune, src/ps_lattice.c:1526-1567).
        Returns the number of links pruned.  When posteriors have not
        been computed yet, runs posterior() with the given lm/ascale
        (ADVICE r2: no silent LM-free fallback)."""
        if not self.links:
            return 0
        if getattr(self, "_alpha", None) is None \
                or any(l.post <= NEG_INF for l in self.links):
            self.posterior(lm=lm, ascale=ascale)
        keep = [li for li, l in enumerate(self.links)
                if l.alpha + l.beta - self.norm >= beam
                or l.src == self.start or l.dst == self.end]
        npruned = len(self.links) - len(keep)
        if not npruned:
            return 0
        newid = {li: i for i, li in enumerate(keep)}
        self.links = [self.links[li] for li in keep]
        for n in self.nodes:
            n.entries = [newid[li] for li in n.entries if li in newid]
            n.exits = [newid[li] for li in n.exits if li in newid]
        self._alpha = None
        self._delete_unreachable()
        return npruned

    def node_posterior(self, word: str, sf: int) -> float:
        """Posterior of word starting at sf: log-sum of alpha+beta-norm
        over ALL exit links of the node (and same-frame alternate
        pronunciations) — the reference's per-segment probability
        (ps_lattice_link2itor, src/ps_lattice.c:946-962)."""
        base = word.split("(")[0]
        total = NEG_INF
        for n in self.nodes:
            if n.sf != sf or n.base != base:
                continue
            for li in n.exits:
                p = self.links[li].post
                if p <= NEG_INF / 2:
                    continue
                if total <= NEG_INF / 2:
                    total = p
                else:
                    m = max(total, p)
                    total = m + math.log1p(math.exp(min(total, p) - m))
        return min(math.exp(total), 1.0) if total > NEG_INF / 2 else 0.0

    def link_posterior(self, word: str, sf: int, ef: int) -> float:
        """Posterior probability of a specific word segment (sums over
        matching links)."""
        total = NEG_INF
        for l in self.links:
            n = self.nodes[l.src]
            if n.word == word and n.sf == sf and l.ef == ef:
                if total <= NEG_INF / 2:
                    total = l.post
                else:
                    m = max(total, l.post)
                    total = m + math.log1p(math.exp(min(total, l.post) - m))
        return min(math.exp(total), 1.0) if total > NEG_INF / 2 else 0.0

    # -- N-best (A*) ---------------------------------------------------------

    def nbest(self, n: int, lm=None, lwf: float = 1.0,
              silpen: float = 0.0, fillpen: float = 0.0):
        """A* search over links with REAL n-gram path scoring
        (ps_astar_start/next/hyp, src/ps_lattice.c:1673-1850): each
        extension to word w1 scores lwf * tg(w1 | w3, w2) over the
        path's carried real-word history (bg for the first extension,
        :1673-1692), and the admissible remaining-score heuristic is
        the reverse bigram DP of best_rem_score (:1580-1606).  The
        reference's DAG bypasses fillers before A*; ours keeps filler
        nodes, so fillers score silpen/fillpen and pass the LM history
        through unchanged — the same net path score.

        Yields up to n (hyp, score) in descending score order."""
        import heapq
        order = self._topo_links()

        def wid_of(nid: int) -> int:
            node = self.nodes[nid]
            if lm is None or not node.base:
                return -1
            return lm.wid(node.base)

        def is_fil(nid: int) -> bool:
            # dict_filler_word semantics: <s>/</s> are real words here
            return self._lat_fil(self.nodes[nid]) and nid != self.end \
                and nid != self.start

        def fil_pen(nid: int) -> float:
            return silpen if self.nodes[nid].word == "<sil>" else fillpen

        def lm_ext(w1: int, h1: int, h2: int) -> float:
            """lwf-weighted LM score of extending history (h2, h1)
            with w1 (shifted units)."""
            if lm is None or w1 < 0:
                return 0.0
            hist = [h2, h1] if h2 >= 0 else ([h1] if h1 >= 0 else [])
            return lm.score(w1, hist) / SHIFT * lwf

        # heuristic: best remaining score from each node to the end,
        # using bigram LM like best_rem_score (src/ps_lattice.c:1590)
        rem = np.full(len(self.nodes), NEG_INF)
        rem[self.end] = 0.0
        for li in reversed(order):
            l = self.links[li]
            if rem[l.dst] <= NEG_INF / 2:
                continue
            step = l.ascr + rem[l.dst]
            if is_fil(l.dst):
                step += fil_pen(l.dst)
            else:
                w = wid_of(l.dst)
                h = wid_of(l.src)
                if w >= 0:
                    step += lm.score(w, [h] if h >= 0 else []) \
                        / SHIFT * lwf
            if step > rem[l.src]:
                rem[l.src] = step

        # search states: (-(g+h), counter, node, g, h1, h2, path);
        # (h1, h2) = carried real-word LM history
        cnt = 0
        h0 = wid_of(self.start)
        heap = [(-(0.0 + rem[self.start]), cnt, self.start, 0.0,
                 h0, -1, ())]
        results = []
        seen = set()
        while heap and len(results) < n:
            negf, _, nid, g, h1, h2, path = heapq.heappop(heap)
            if nid == self.end:
                words = tuple(self.nodes[self.links[li].src].base
                              for li in path
                              if not self.nodes[self.links[li].src].is_fill)
                if words not in seen:
                    seen.add(words)
                    results.append((" ".join(words), g))
                continue
            for li in self.nodes[nid].exits:
                l = self.links[li]
                g2 = g + l.ascr
                n1, n2 = h1, h2
                if l.dst != self.end:
                    if is_fil(l.dst):
                        g2 += fil_pen(l.dst)
                    else:
                        w1 = wid_of(l.dst)
                        g2 += lm_ext(w1, h1, h2)
                        if w1 >= 0:
                            n1, n2 = w1, h1
                cnt += 1
                heapq.heappush(heap, (-(g2 + rem[l.dst]), cnt, l.dst,
                                      g2, n1, n2, path + (li,)))
        return results

    # -- output --------------------------------------------------------------

    def _node_ef_range(self, n: LatNode):
        """(first, last) end frame over a node's exit links; final node
        (no exits) spans to the last frame like the reference's bptbl."""
        efs = [self.links[li].ef for li in n.exits]
        if not efs:
            return self.n_frames - 1, self.n_frames - 1
        return min(efs), max(efs)

    def write_htk(self, path: str):
        """HTK SLF format (ps_lattice_write_htk, src/ps_lattice.c:271-349):
        !SENT_START/!SENT_END/!NULL word mapping, v= alternate index,
        a= acoustic score in nats, p= link posterior."""
        with open(path, "w") as f:
            f.write("# Lattice generated by PocketSphinx\n")
            f.write("#\n# Header\n#\n")
            f.write("VERSION=1.0\n")
            f.write(f"start={self.start}\nend={self.end}\n#\n")
            f.write(f"N={len(self.nodes)}\tL={len(self.links)}\n")
            f.write("#\n# Node definitions\n#\n")
            for n in self.nodes:
                altpron = 1
                if "(" in n.word:
                    try:
                        altpron = int(n.word[n.word.rindex("(") + 1:-1])
                    except ValueError:
                        pass
                if n.word == "<s>":
                    w = "!SENT_START"
                elif n.word == "</s>":
                    w = "!SENT_END"
                elif n.is_fill:
                    w = "!NULL"
                else:
                    w = n.base
                f.write(f"I={n.id}\tt={n.sf / self.frate:.2f}\tW={w}"
                        f"\tv={altpron}\n")
            f.write("#\n# Link definitions\n#\n")
            for j, l in enumerate(self.links):
                a = l.ascr * LN_BASE_SHIFTED          # shifted units -> nats
                p = (math.exp(min(l.post, 0.0))
                     if l.post > NEG_INF / 2 else 0.0)
                f.write(f"J={j}\tS={l.src}\tE={l.dst}"
                        f"\ta={a:f}\tp={p:g}\n")

    def write(self, path: str):
        """Sphinx-III DAG format (ps_lattice_write, src/ps_lattice.c:207-268);
        readable by the reference's ps_lattice_read and by Lattice.read.
        Edge scores are raw logmath units (shifted units x 1024)."""
        with open(path, "w") as f:
            f.write("# getcwd: /this/is/bogus\n")
            f.write("# -logbase 1.000100e+00\n#\n")
            f.write(f"Frames {self.n_frames}\n#\n")
            f.write(f"Nodes {len(self.nodes)} "
                    "(NODEID WORD STARTFRAME FIRST-ENDFRAME LAST-ENDFRAME)\n")
            for n in self.nodes:
                fef, lef = self._node_ef_range(n)
                f.write(f"{n.id} {n.word or '(null)'} {n.sf} {fef} {lef}"
                        " ; 0\n")
            f.write("#\n")
            f.write(f"Initial {self.start}\nFinal {self.end}\n#\n")
            f.write("BestSegAscr 0 (NODEID ENDFRAME ASCORE)\n#\n")
            f.write("Edges (FROM-NODEID TO-NODEID ASCORE)\n")
            for l in self.links:
                if l.ascr > 0 or l.ascr <= NEG_INF / 2:
                    continue
                f.write(f"{l.src} {l.dst} {int(round(l.ascr * SHIFT))}\n")
            f.write("End\n")

    # -- input ---------------------------------------------------------------

    @classmethod
    def read_htk(cls, path: str, dictionary=None,
                 frate: int = 100) -> "Lattice":
        """Read an HTK SLF lattice (the format write_htk emits; the
        reference writes but does not read SLF — this closes the loop).
        `a=` scores are nats and are converted back to shifted units."""
        lat = cls(frate=frate)
        n_nodes = n_links = None
        start = end = 0
        times = {}
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                fields = dict(kv.split("=", 1) for kv in ln.split()
                              if "=" in kv)
                if "N" in fields and "L" in fields:
                    n_nodes, n_links = int(fields["N"]), int(fields["L"])
                elif "start" in fields:
                    start = int(fields["start"])
                elif "end" in fields:
                    end = int(fields["end"])
                elif "I" in fields:
                    w = fields.get("W", "!NULL")
                    if w == "!SENT_START":
                        w = "<s>"
                    elif w == "!SENT_END":
                        w = "</s>"
                    is_fill = w == "!NULL" or w.startswith(("<", "[", "++"))
                    sf = int(round(float(fields.get("t", 0)) * frate))
                    times[int(fields["I"])] = sf
                    lat.nodes.append(LatNode(
                        word=w, base=w.split("(")[0], sf=sf,
                        is_fill=is_fill, id=int(fields["I"])))
                elif "J" in fields:
                    src, dst = int(fields["S"]), int(fields["E"])
                    ascr = float(fields.get("a", 0.0)) / LN_BASE_SHIFTED
                    li = len(lat.links)
                    link = LatLink(src=src, dst=dst,
                                   ef=lat.nodes[dst].sf - 1, ascr=ascr)
                    if "p" in fields:
                        p = float(fields["p"])
                        link.post = math.log(p) if p > 0 else NEG_INF
                    lat.links.append(link)
                    lat.nodes[src].exits.append(li)
                    lat.nodes[dst].entries.append(li)
        if n_nodes is not None and len(lat.nodes) != n_nodes:
            raise ValueError(f"{path}: node count mismatch "
                             f"({len(lat.nodes)} != {n_nodes})")
        if n_links is not None and len(lat.links) != n_links:
            raise ValueError(f"{path}: link count mismatch "
                             f"({len(lat.links)} != {n_links})")
        if not lat.nodes:
            raise ValueError(f"{path}: no nodes (not an SLF lattice?)")
        lat.start, lat.end = start, end
        lat.n_frames = max(times.values()) + 1 if times else 0
        if lat.nodes[lat.end].is_fill:
            lat.nodes[lat.end].base = "</s>"
        lat._delete_unreachable()
        return lat

    @classmethod
    def read(cls, path: str, dictionary=None, frate: int = 100) -> "Lattice":
        """Read a Sphinx-III DAG file written by the reference
        (ps_lattice_read, src/ps_lattice.c:388-660) or by Lattice.write.
        Edge scores (raw logmath units) are divided back to shifted units.
        Nodes unreachable from the final node are pruned like the
        reference's dag_mark_reachable + ps_lattice_delete_unreachable."""
        lat = cls(frate=frate)

        def is_fill(word: str) -> bool:
            if dictionary is not None:
                w = dictionary.wordid(word)
                if w >= 0:
                    return dictionary.is_filler(w)
            # <s>/</s>/<sil>/[NOISE]... all live in the filler dict
            # in the reference, so they are non-words for the hyp
            base = word.split("(")[0]
            return base.startswith(("<", "[", "++"))

        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f]
        it = iter(lines)

        def param(name: str) -> int:
            for ln in it:
                if ln.startswith("#"):
                    continue
                parts = ln.split()
                if parts and parts[0].startswith(name) and len(parts) > 1:
                    try:
                        return int(parts[1])
                    except ValueError:
                        continue
            return -1

        lat.n_frames = param("Frames")
        if lat.n_frames <= 0:
            raise ValueError(f"{path}: Frames parameter missing")
        n_nodes = param("Nodes")
        if n_nodes <= 0:
            raise ValueError(f"{path}: Nodes parameter missing")
        for i in range(n_nodes):
            ln = next(it)
            parts = ln.split()
            if len(parts) < 5 or int(parts[0]) != i:
                raise ValueError(f"{path}: bad node line: {ln!r}")
            word, sf = parts[1], int(parts[2])
            lat.nodes.append(LatNode(word=word, base=word.split("(")[0],
                                     sf=sf, is_fill=is_fill(word), id=i))
        lat.start = param("Initial")
        lat.end = param("Final")
        if not (0 <= lat.start < n_nodes and 0 <= lat.end < n_nodes):
            raise ValueError(f"{path}: Initial/Final missing")
        for _ in range(max(param("BestSegAscr"), 0)):
            next(it)
        for ln in it:
            if ln.startswith("Edges"):
                break
        else:
            raise ValueError(f"{path}: Edges missing")
        ended = False
        for ln in it:
            if ln.startswith("#"):
                continue
            parts = ln.split()
            if len(parts) != 3:
                ended = ln.strip() == "End"
                break
            src, dst, raw = int(parts[0]), int(parts[1]), int(parts[2])
            li = len(lat.links)
            lat.links.append(LatLink(src=src, dst=dst,
                                     ef=lat.nodes[dst].sf - 1,
                                     ascr=raw / SHIFT))
            lat.nodes[src].exits.append(li)
            lat.nodes[dst].entries.append(li)
        if not ended:
            raise ValueError(f"{path}: terminating 'End' missing")
        # final-filler hack: score it as </s> for LM purposes
        if lat.nodes[lat.end].is_fill:
            lat.nodes[lat.end].base = "</s>"
        lat._delete_unreachable()
        return lat

    def _delete_unreachable(self):
        """Prune nodes with no path to the final node, renumber, and
        rebuild link endpoints (ps_lattice_delete_unreachable)."""
        reach = set()
        stack = [self.end]
        while stack:
            nid = stack.pop()
            if nid in reach:
                continue
            reach.add(nid)
            for li in self.nodes[nid].entries:
                stack.append(self.links[li].src)
        newid = {}
        nodes = []
        for n in self.nodes:
            if n.id in reach:
                newid[n.id] = len(nodes)
                nodes.append(n)
        links = []
        linkid = {}
        for i, l in enumerate(self.links):
            if l.src in reach and l.dst in reach:
                linkid[i] = len(links)
                l.src, l.dst = newid[l.src], newid[l.dst]
                links.append(l)
        for n in nodes:
            n.id = newid[n.id]
            n.entries = [linkid[i] for i in n.entries if i in linkid]
            n.exits = [linkid[i] for i in n.exits if i in linkid]
        self.nodes, self.links = nodes, links
        self.start = newid.get(self.start, 0)
        self.end = newid[self.end]
