"""Cross-word triphone context tables (src/dict2pid.c re-design).

Builds the dense arrays that make cross-word context modeling feasible in
search:

  * ``ldiph_lc[b, rc, lc]``  -> ssid of word-*initial* triphone (wpos 'b')
  * ``lrdiph_rc[b, lc, rc]`` -> ssid of *single-phone-word* triphone ('s')
  * ``rdiph_rc[b, lc, rc]``  -> ssid of word-*final* triphone ('e'),
    plus the compressed form (unique ssid list + rc -> index cimap) the
    reference calls xwdssid_t.
  * per-word internal ssids (``word_internal_ssid(wid)``)

All lookups go through a dense [wpos, b, lc, rc] phone-id table built by
one cd_tree traversal, followed by the same word-position / silence
backoff chain as bin_mdef_phone_id_nearest (src/bin_mdef.c:812-864),
fully vectorized over contexts.
"""

from __future__ import annotations

import numpy as np

from ..fileio.bin_mdef import (BinMdef, WPOS_BEGIN, WPOS_END, WPOS_INTERNAL,
                               WPOS_SINGLE, N_WORD_POSN)
from ..fileio.dictionary import Dictionary


def _nearest_pid_grid(mdef: BinMdef, wpos: int, b: np.ndarray,
                      lc: np.ndarray, rc: np.ndarray) -> np.ndarray:
    """Vectorized bin_mdef_phone_id_nearest over same-shape b/lc/rc arrays."""
    tbl = mdef.dense_pid_table()
    filler = mdef.phone_filler[:mdef.n_ciphone]
    sil = mdef.sil

    def mapped(x):
        return np.where((sil >= 0) & filler[x], sil, x)

    ml, mr = mapped(lc), mapped(rc)

    def lookup(w, l, r):
        return tbl[w, b, l, r]

    out = lookup(wpos, ml, mr)
    # word-position backoff
    for tmppos in range(N_WORD_POSN):
        if tmppos == wpos:
            continue
        miss = out < 0
        if not miss.any():
            break
        out = np.where(miss, lookup(tmppos, ml, mr), out)
    # silence-context backoff
    if sil >= 0:
        newl = np.where(filler[lc] | (wpos in (WPOS_BEGIN, WPOS_SINGLE)),
                        sil, ml)
        newr = np.where(filler[rc] | (wpos in (WPOS_END, WPOS_SINGLE)),
                        sil, mr)
        changed = (newl != ml) | (newr != mr)
        miss = (out < 0) & changed
        if miss.any():
            out = np.where(miss, lookup(wpos, newl, newr), out)
            for tmppos in range(N_WORD_POSN):
                if tmppos == wpos:
                    continue
                miss = (out < 0) & changed
                if not miss.any():
                    break
                out = np.where(miss, lookup(tmppos, newl, newr), out)
    # base-phone fallback
    return np.where(out < 0, b, out).astype(np.int32)


class Dict2Pid:
    def __init__(self, mdef: BinMdef, dictionary: Dictionary):
        self.mdef = mdef
        self.dict = dictionary
        nc = mdef.n_ciphone
        ci = np.arange(nc, dtype=np.int32)
        B = ci[:, None, None] + np.zeros((nc, nc, nc), np.int32)
        X = ci[None, :, None] + np.zeros((nc, nc, nc), np.int32)
        Y = ci[None, None, :] + np.zeros((nc, nc, nc), np.int32)
        ssid_of = mdef.phone_ssid
        # ldiph_lc[b][rc][lc]: begin-position triphone (b, lc, rc)
        self.ldiph_lc = ssid_of[
            _nearest_pid_grid(mdef, WPOS_BEGIN, B, Y, X)].astype(np.uint16)
        # lrdiph_rc[b][lc][rc]: single-phone-word triphone
        self.lrdiph_rc = ssid_of[
            _nearest_pid_grid(mdef, WPOS_SINGLE, B, X, Y)].astype(np.uint16)
        # rdiph_rc[b][lc][rc]: end-position triphone
        self.rdiph_rc = ssid_of[
            _nearest_pid_grid(mdef, WPOS_END, B, X, Y)].astype(np.uint16)
        # internal[b][lc][rc]: word-internal triphone (`internal_ssids`,
        # whose lookup is elementwise, gathers from it)
        self.internal = ssid_of[
            _nearest_pid_grid(mdef, WPOS_INTERNAL, B, X, Y)].astype(np.uint16)
        # compressed right-context sets (xwdssid_t equivalents):
        # for each (b, lc): unique ssids over rc + cimap
        self.rssid_cimap = np.zeros((nc, nc, nc), dtype=np.int16)
        self.rssid_list: list[list[np.ndarray]] = []
        for b in range(nc):
            row = []
            for l in range(nc):
                ssids = self.rdiph_rc[b, l]
                uniq, inv = np.unique(ssids, return_inverse=True)
                # preserve first-occurrence order like dict2pid's compress
                first = np.sort(np.unique(inv, return_index=True)[1])
                order = inv[first]  # unique codes in first-seen order
                remap = np.empty(len(uniq), dtype=np.int16)
                remap[order] = np.arange(len(uniq))
                row.append(uniq[order].astype(np.uint16))
                self.rssid_cimap[b, l] = remap[inv]
            self.rssid_list.append(row)
        self._internal_cache: dict[int, np.ndarray] = {}

    # -- queries -------------------------------------------------------------

    def internal_ssids(self, wid: int) -> np.ndarray:
        """ssids of word-internal phones (positions 1..len-2)."""
        if wid in self._internal_cache:
            return self._internal_cache[wid]
        p = np.asarray(self.dict.pron(wid), np.int64)
        out = self.internal[p[1:-1], p[:-2], p[2:]] if len(p) > 2 else \
            np.zeros(0, dtype=np.uint16)
        self._internal_cache[wid] = out
        return out

    def rssid(self, b: int, lc: int):
        """(unique ssid array, cimap row) for a word-final phone b with
        left context lc."""
        return self.rssid_list[b][lc], self.rssid_cimap[b, lc]
