"""MLLR speaker adaptation (src/ps_mllr.c + gauden_mllr_transform,
src/ms_gauden.c:512-572).

Text file format: n_class, n_feat, then per stream: veclen, then per
class: A [len x len] rotation, b [len] bias, h [len] variance scale.
Applied as mean' = A @ mean + b, var' = var * h (class 0 only, like the
reference), then the Gaussian precomputation re-runs.  A copy of
`pocketsphinx_tpu.models.mllr` (host NumPy).
"""

from __future__ import annotations

import numpy as np

from ..logmath import LogMath, default_logmath


class Mllr:
    def __init__(self, A, b, h):
        self.A = A          # list per stream: [n_class, len, len]
        self.b = b          # [n_class, len]
        self.h = h          # [n_class, len]

    @property
    def n_feat(self):
        return len(self.A)

    @classmethod
    def read(cls, path: str) -> "Mllr":
        toks = iter(open(path).read().split())

        def nxt():
            return next(toks)

        n_class = int(nxt())
        n_feat = int(nxt())
        A, b, h = [], [], []
        for f in range(n_feat):
            ln = int(nxt())
            Af = np.empty((n_class, ln, ln), np.float64)
            bf = np.empty((n_class, ln), np.float64)
            hf = np.empty((n_class, ln), np.float64)
            for m in range(n_class):
                for j in range(ln):
                    for k in range(ln):
                        Af[m, j, k] = float(nxt())
                for j in range(ln):
                    bf[m, j] = float(nxt())
                for j in range(ln):
                    hf[m, j] = float(nxt())
            A.append(Af)
            b.append(bf)
            h.append(hf)
        return cls(A, b, h)

    def transform(self, gauden, lmath: LogMath | None = None,
                  varfloor: float = 1e-4):
        """Apply to a Gauden in place (class 0, like the reference) and
        re-run the precomputation."""
        lmath = lmath or default_logmath()
        g = gauden
        for f in range(min(self.n_feat, g.n_feat)):
            ln = len(self.b[f][0])
            mean = g.means[:, f, :, :ln].astype(np.float64)
            g.means[:, f, :, :ln] = (
                np.einsum("lm,cdm->cdl", self.A[f][0], mean)
                + self.b[f][0][None, None, :]).astype(np.float32)
            g.var[:, f, :, :ln] = (g.var[:, f, :, :ln]
                                   * self.h[f][0][None, None, :]
                                   ).astype(np.float32)
        g.precompute(lmath, varfloor)
        return g
