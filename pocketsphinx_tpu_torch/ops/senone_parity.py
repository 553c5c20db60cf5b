"""Bit-exact int-parity PTM senone scorer (host-side NumPy).

Reproduces src/ptm_mgau.c frame evaluation exactly — including float32
accumulation order, int32 truncation, the streaming top-N insertion
discipline, the >>SENSCR_SHIFT normalization, and the 8-bit table log-add —
so that golden `-senlogdir -compallsen yes` dumps from the reference binary
can be matched bit-for-bit.  This is the parity oracle for the fast TPU
float scorer (`models.acoustic.senone_scores`); it is NOT the production
path.  A copy of `pocketsphinx_tpu.ops.senone_parity`.

Pipeline per frame (reference line references):
  1. eval_topn (ptm_mgau.c:88-136):  rescore previous frame's top-N
     codewords per (codebook, stream), stable-sort descending.
  2. eval_cb (ptm_mgau.c:153-228):   scan all densities; candidate enters
     the top-N if its float32 score >= float(current worst int score) and
     it is not already present; insertion places it above ties.
  3. ptm_mgau_codebook_norm (:266):  per stream, norm = max top-1 score
     >> SENSCR_SHIFT; every top-N score -> clamped negated cost.
  4. ptm_mgau_senone_eval (:327):    per senone, per stream: fold
     fast_logmath_add over top-N of (mixw + cost); sum streams; subtract
     per-frame best -> int16 costs, 0 = best.
"""

from __future__ import annotations

import numpy as np

from ..logmath import (MAX_NEG_ASCR, MAX_NEG_INT32, SENSCR_SHIFT,
                       senscr_logmath)

WORST_DIST = MAX_NEG_INT32


class PTMParityScorer:
    def __init__(self, gauden, mixw, sen2cb, max_topn: int = 4):
        self.g = gauden
        self.mixw = mixw.mixw          # [n_feat, n_density, n_sen] uint8
        self.sen2cb = np.asarray(sen2cb, dtype=np.int64)
        self.max_topn = max_topn
        self.n_sen = self.mixw.shape[2]
        lm8 = senscr_logmath()
        self.add_tbl = lm8.table.astype(np.int64)  # >=256 entries
        self.reset()

    def reset(self):
        g = self.g
        K = self.max_topn
        # topn state per (codebook, stream): cw ids + int32 scores, sorted desc
        self.top_cw = np.tile(np.arange(K, dtype=np.int64),
                              (g.n_mgau, g.n_feat, 1))
        self.top_sc = np.full((g.n_mgau, g.n_feat, K), WORST_DIST,
                              dtype=np.int64)

    # -- density math (float32, reference accumulation order) ----------------

    def _dens_all(self, z: np.ndarray) -> np.ndarray:
        """All density scores for one frame: float32 [n_mgau, n_feat, n_density].
        d = det - sum_dims (x-mean)^2 * prec, subtracted dimension-at-a-time
        in float32 exactly like the unrolled C loops."""
        g = self.g
        det = g.det.astype(np.float32)           # int values in float32
        mean = g.means                            # [M,F,D,13] f32
        prec = g.prec.astype(np.float32)          # int values in float32
        d = det.copy()
        x = z.astype(np.float32)                  # [F, 13]
        for i in range(mean.shape[-1]):
            diff = x[None, :, None, i] - mean[..., i]
            compl_ = (diff * diff) * prec[..., i]
            d = d - compl_
        return d

    @staticmethod
    def _to_int(d: np.ndarray) -> np.ndarray:
        """(int32)d with the reference's explicit MAX_NEG_INT32 clamp."""
        out = np.trunc(d.astype(np.float64))
        out = np.where(d < np.float32(MAX_NEG_INT32), MAX_NEG_INT32, out)
        return out.astype(np.int64)

    # -- per-frame evaluation ------------------------------------------------

    def frame(self, z: np.ndarray) -> np.ndarray:
        """z: [n_feat, 13] float32 feature frame -> int16[n_sen] scores."""
        g, K = self.g, self.max_topn
        d_all = self._dens_all(z)                         # [M, F, D] f32
        i_all = self._to_int(d_all)                       # int

        M, F = g.n_mgau, g.n_feat
        flat = (M * F)
        d2 = d_all.reshape(flat, -1)
        i2 = i_all.reshape(flat, -1)

        # 1. eval_topn: rescore previous top-N (gather by stored cw),
        #    stable descending sort.
        rows = np.arange(flat)[:, None]
        pc = self.top_cw.reshape(flat, K)
        ps = i2[rows, pc]                                  # rescored ints
        order = np.argsort(-ps, axis=1, kind="stable")
        cw = np.take_along_axis(pc, order, axis=1)
        sc = np.take_along_axis(ps, order, axis=1)

        # 2. eval_cb streaming scan over all densities.
        n_density = d2.shape[1]
        for c in range(n_density):
            dflt = d2[:, c]
            worst = sc[:, K - 1]
            accept = dflt >= worst.astype(np.float32)
            present = (cw == c).any(axis=1)
            accept &= ~present
            if not accept.any():
                continue
            cint = i2[:, c]
            # insertion position = number of entries strictly greater
            pos = (sc > cint[:, None]).sum(axis=1)
            # shift entries at >= pos down by one, drop last
            take = np.where(accept[:, None], pos[:, None], K + 1)
            idx = np.arange(K)[None, :]
            shift = idx >= take
            new_sc = np.where(shift, np.concatenate(
                [sc[:, :1], sc[:, :-1]], axis=1), sc)
            new_cw = np.where(shift, np.concatenate(
                [cw[:, :1], cw[:, :-1]], axis=1), cw)
            at = idx == take
            sc = np.where(at, cint[:, None], new_sc)
            cw = np.where(at, np.int64(c), new_cw)

        self.top_cw = cw.reshape(M, F, K)
        self.top_sc = sc.reshape(M, F, K)

        # 3. normalize per stream (all codebooks active / compallsen)
        shifted = self.top_sc >> SENSCR_SHIFT                 # [M,F,K]
        norm = shifted[:, :, 0].max(axis=0)                   # [F]
        cost = -(shifted - norm[None, :, None])
        cost = np.minimum(cost, MAX_NEG_ASCR)                 # [M,F,K]

        # 4. senone eval: fold fast_logmath_add over top-N in order.
        cb = self.sen2cb                                      # [n_sen]
        mixw = self.mixw                                      # [F,D,S] uint8
        sens = np.arange(self.n_sen)
        ascore = np.zeros(self.n_sen, dtype=np.int64)
        for f in range(F):
            cwf = self.top_cw[:, :, :][cb, f]                 # [S,K]
            cstf = cost[cb, f]                                # [S,K]
            mw = mixw[f][cwf, sens[:, None]]                  # [S,K]
            val = mw.astype(np.int64) + cstf
            fden = val[:, 0]
            for j in range(1, K):
                a, b = fden, val[:, j]
                r = np.minimum(a, b)
                dd = np.abs(a - b)
                fden = r - self.add_tbl[np.minimum(dd, len(self.add_tbl) - 1)]
            ascore += fden
        best = ascore.min()
        return (ascore - best).astype(np.int16)

    def score_utt(self, feats: np.ndarray) -> np.ndarray:
        """feats: [T, n_feat, 13] -> int16 [T, n_sen]."""
        return np.stack([self.frame(feats[t]) for t in range(len(feats))])
