"""Word-HMM chain construction for the dense decoders.

Port of `pocketsphinx_tpu.models.chains` (host NumPy code, copied).  The
n-gram flat decoder and the FSG decoder lay a word's phones out as
consecutive HMM rows: first phone, exact internal triphones, and the
final phone fanned per compressed right-context class (dict2pid's
xwdssid design).

Two first-phone modes:
  * `append_word_chain` (the FSG decoder's): a single first-phone node
    with SIL left context;
  * `append_word_chain_mpx` (the flat decoder's): the first phone is
    replicated per compressed LEFT-context class (the dense equivalent of
    the reference's multiplexed-ssid channels, src/hmm.h mpx +
    dict2pid_ldiph_lc usage in src/ngram_search_fwdtree.c:1241-1310), and
    single-phone words are replicated per (left-class x right-class) so
    both cross-word contexts are exact (lrdiph_rc, src/dict2pid.c).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class WordChain:
    """Layout of one word's nodes in the dense network (mpx mode)."""

    first_lo: int           # first-phone variant rows [first_lo, first_hi)
    first_hi: int
    lc_cls: np.ndarray      # [n_ci] -> first-phone variant offset
    # exit slots: one per compressed right-context class; each slot owns
    # >= 1 final-phone node (single-phone words have one node per
    # surviving (lc, rc) pair, all mapped to the rc slot)
    n_slot: int
    rc_cls: np.ndarray      # [n_ci] -> exit slot offset
    final_nodes: list       # (node, slot_offset) pairs
    final_base_ci: int      # base CI phone of the last pron phone
    single: bool = False    # single-phone real word ((lc, rc) product)
    filler: bool = False    # CI filler chain (context-free entry)


@dataclass
class ChainRows:
    """Accumulator for the node-major arrays of a decoder network."""

    senid: list = field(default_factory=list)        # [*, n_emit] rows
    tmat: list = field(default_factory=list)
    chain_pred: list = field(default_factory=list)   # intra-word pred or -1
    owner: list = field(default_factory=list)        # word/arc index

    def __len__(self):
        return len(self.senid)


def append_word_chain_mpx(rows: ChainRows, dictionary, mdef, d2p,
                          wid: int, owner: int, n_ci: int) -> WordChain:
    """Append one word's chain with exact cross-word triphones on BOTH
    boundaries: first phone replicated per compressed left-context
    class (ldiph_lc), final phone per compressed right-context class
    (xwdssid), single-phone words per (lc, rc) product class
    (lrdiph_rc).  chain_pred == -2 marks a node whose predecessor is
    the whole first-phone variant group of its word."""
    sil = mdef.sil
    pron = [int(x) for x in dictionary.pron(wid)]
    L = len(pron)
    first = len(rows)
    if dictionary.is_filler(wid) or (L == 1 and pron[0] == sil):
        for j, ci in enumerate(pron):
            rows.senid.append(mdef.sseq[mdef.phone_ssid[ci]])
            rows.tmat.append(mdef.phone_tmat[ci])
            rows.chain_pred.append(len(rows) - 2 if j else -1)
            rows.owner.append(owner)
        return WordChain(first_lo=first, first_hi=first + 1,
                         lc_cls=np.zeros(n_ci, np.int16), n_slot=1,
                         rc_cls=np.zeros(n_ci, np.int16),
                         final_nodes=[(len(rows) - 1, 0)],
                         final_base_ci=pron[-1], filler=True)
    if L == 1:
        # single-phone word: exact (lc, rc) contexts via lrdiph_rc
        table = d2p.lrdiph_rc[pron[0]]              # [n_ci(lc), n_ci(rc)]
        lc_uniq, lc_inv = np.unique(table, axis=0, return_inverse=True)
        rc_uniq, rc_inv = np.unique(table, axis=1, return_inverse=True)
        n_lc, n_rc = len(lc_uniq), rc_uniq.shape[1]
        final_nodes = []
        for li in range(n_lc):
            rep_lc = int(np.nonzero(lc_inv == li)[0][0])
            for ri in range(n_rc):
                rep_rc = int(np.nonzero(rc_inv == ri)[0][0])
                ssid = int(table[rep_lc, rep_rc])
                rows.senid.append(mdef.sseq[ssid])
                rows.tmat.append(mdef.phone_tmat[pron[0]])
                rows.chain_pred.append(-1)
                rows.owner.append(owner)
                final_nodes.append((len(rows) - 1, ri))
        # entry variant offset of a node = its position in row-major
        # (lc, rc) order; entry targets every rc variant of its lc row,
        # so lc_cls maps ci -> lc row index scaled by n_rc (the caller
        # expands to the rc fan via the per-node entry masks)
        return WordChain(first_lo=first, first_hi=len(rows),
                         lc_cls=lc_inv.astype(np.int16),
                         n_slot=n_rc, rc_cls=rc_inv.astype(np.int16),
                         final_nodes=final_nodes,
                         final_base_ci=pron[0], single=True)
    # multi-phone word: first phone per compressed left-context class
    lc_tab = d2p.ldiph_lc[pron[0], pron[1]]          # [n_ci] -> ssid
    lc_uniq, lc_inv = np.unique(lc_tab, return_inverse=True)
    for ssid in lc_uniq:
        rows.senid.append(mdef.sseq[int(ssid)])
        rows.tmat.append(mdef.phone_tmat[pron[0]])
        rows.chain_pred.append(-1)
        rows.owner.append(owner)
    first_hi = len(rows)
    internal = d2p.internal_ssids(wid)
    for j in range(1, L - 1):
        rows.senid.append(mdef.sseq[int(internal[j - 1])])
        rows.tmat.append(mdef.phone_tmat[pron[j]])
        # second phone's predecessor is the whole first-variant group
        rows.chain_pred.append(len(rows) - 2 if j > 1 else -2)
        rows.owner.append(owner)
    uniq, cimap = d2p.rssid(pron[-1], pron[-2])
    pre = len(rows) - 1
    final_nodes = []
    for k, ssid in enumerate(uniq):
        rows.senid.append(mdef.sseq[int(ssid)])
        rows.tmat.append(mdef.phone_tmat[pron[-1]])
        rows.chain_pred.append(-2 if L == 2 else pre)
        rows.owner.append(owner)
        final_nodes.append((len(rows) - 1, k))
    return WordChain(first_lo=first, first_hi=first_hi,
                     lc_cls=lc_inv.astype(np.int16), n_slot=len(uniq),
                     rc_cls=cimap.astype(np.int16),
                     final_nodes=final_nodes, final_base_ci=pron[-1])


def append_word_chain(rows: ChainRows, dictionary, mdef, d2p, wid: int,
                      owner: int, n_ci: int):
    """Append one word's phone chain; returns
    (first_node, final_base, n_class, cls_row[n_ci])."""
    sil = mdef.sil
    pron = [int(x) for x in dictionary.pron(wid)]
    L = len(pron)
    first = len(rows)
    if dictionary.is_filler(wid) or (L == 1 and pron[0] == sil):
        # fillers decode with CI phones
        for j, ci in enumerate(pron):
            rows.senid.append(mdef.sseq[mdef.phone_ssid[ci]])
            rows.tmat.append(mdef.phone_tmat[ci])
            rows.chain_pred.append(len(rows) - 2 if j else -1)
            rows.owner.append(owner)
        return first, len(rows) - 1, 1, np.zeros(n_ci, np.int16)
    if L == 1:
        # single-phone word: both contexts unknown; SIL left context,
        # right-context classes from the two-sided table
        uniq, inv = np.unique(d2p.lrdiph_rc[pron[0], sil],
                              return_inverse=True)
        for ssid in uniq:
            rows.senid.append(mdef.sseq[int(ssid)])
            rows.tmat.append(mdef.phone_tmat[pron[0]])
            rows.chain_pred.append(-1)
            rows.owner.append(owner)
        return first, first, len(uniq), inv.astype(np.int16)
    # first phone (lc = SIL approximation)
    rows.senid.append(mdef.sseq[int(d2p.ldiph_lc[pron[0], pron[1], sil])])
    rows.tmat.append(mdef.phone_tmat[pron[0]])
    rows.chain_pred.append(-1)
    rows.owner.append(owner)
    # exact word-internal triphones
    internal = d2p.internal_ssids(wid)
    for j in range(1, L - 1):
        rows.senid.append(mdef.sseq[int(internal[j - 1])])
        rows.tmat.append(mdef.phone_tmat[pron[j]])
        rows.chain_pred.append(len(rows) - 2)
        rows.owner.append(owner)
    # final phone: one node per compressed right-context class
    uniq, cimap = d2p.rssid(pron[-1], pron[-2])
    pre = len(rows) - 1
    final_base = len(rows)
    for ssid in uniq:
        rows.senid.append(mdef.sseq[int(ssid)])
        rows.tmat.append(mdef.phone_tmat[pron[-1]])
        rows.chain_pred.append(pre)
        rows.owner.append(owner)
    return first, final_base, len(uniq), cimap.astype(np.int16)
