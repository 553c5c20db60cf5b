"""Word-HMM chain construction for the FSG decoder's dense network.

Port of `pocketsphinx_tpu.models.chains` (host NumPy code, copied): the
FSG decoder lays a word's phones out as consecutive HMM rows: first
phone (SIL left context), exact internal triphones, and the final phone
fanned per compressed right-context class (dict2pid's xwdssid design).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ChainRows:
    """Accumulator for the node-major arrays of a decoder network."""

    senid: list = field(default_factory=list)        # [*, n_emit] rows
    tmat: list = field(default_factory=list)
    chain_pred: list = field(default_factory=list)   # intra-word pred or -1
    owner: list = field(default_factory=list)        # word/arc index

    def __len__(self):
        return len(self.senid)


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
