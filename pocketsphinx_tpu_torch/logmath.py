"""Integer log-domain arithmetic, base 1.0001 — the reference numeric contract.

PocketSphinx stores *all* probabilities as int32 logs in a tiny base
(default 1.0001), so that log-probability sums stay in integer range and
log-add can be a table lookup (reference: src/util/logmath.c).

The device code computes in float32 log domain, but expressed in the
*same units* (log base 1.0001), so that beam widths, language-model
weights and acoustic scores from reference model files are directly
comparable.  This module provides:

  * ``LogMath`` — a vectorized NumPy re-derivation of the reference
    int32 table arithmetic (logmath_init/logmath_log/logmath_add), used
    by host-side model loading and by int-parity tests against golden
    senone-score dumps.
  * float helpers used by the device code.

Reference behaviors reproduced (src/util/logmath.c:63-213,402-470):
  * ``zero`` = MAX_NEG_INT32 >> (shift + 2)
  * log(p)  = int(ln(p)/ln(base)) >> shift   (C truncation toward zero)
  * add table construction with the rounding/shift scheme of logmath_init
  * fast_logmath_add 8-bit variant for negated (cost) values
    (src/tied_mgau_common.h:111).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

MAX_NEG_INT32 = -2147483648

# Score constants from src/hmm.h:72-89 and src/tied_mgau_common.h:60-91.
SENSCR_SHIFT = 10
WORST_SCORE = -536870912  # (int)0xE0000000
WORST_DIST = MAX_NEG_INT32
TMAT_WORST_SCORE = -255
MAX_NEG_MIXW = 159
MAX_NEG_ASCR = 96


def _build_add_table(base: float, shift: int) -> np.ndarray:
    """Re-derive the log-add table of logmath_init (src/util/logmath.c:91-160).

    Entry d of the table is round(log_base(1 + base^-d')) >> shift evaluated
    at the *first* d' mapping to index d (the reference keeps the first
    nonzero write per slot).
    """
    inv_log_of_base = 1.0 / math.log(base)
    # Size pass.
    byx = 1.0
    i = 0
    while True:
        lobyx = math.log1p(byx) * inv_log_of_base
        k = int(lobyx + 0.5 * (1 << shift)) >> shift
        if k <= 0:
            break
        byx /= base
        i += 1
    n = i >> shift
    if n < 255:
        n = 255
    table = np.zeros(n + 1, dtype=np.uint32)
    written = np.zeros(n + 1, dtype=bool)
    byx = 1.0
    i = 0
    while True:
        lobyx = math.log1p(byx) * inv_log_of_base
        k = int(lobyx + 0.5 * (1 << shift)) >> shift
        idx = i >> shift
        if idx <= n and not written[idx] and table[idx] == 0:
            table[idx] = k
            written[idx] = True
        if k <= 0:
            break
        byx /= base
        i += 1
    return table


@dataclass
class LogMath:
    """Vectorized int32 logmath in a given base (default 1.0001)."""

    base: float = 1.0001
    shift: int = 0
    use_table: bool = True
    table: np.ndarray | None = field(default=None, repr=False)

    def __post_init__(self):
        self.log_of_base = math.log(self.base)
        self.inv_log_of_base = 1.0 / self.log_of_base
        self.inv_log10_of_base = 1.0 / math.log10(self.base)
        self.zero = MAX_NEG_INT32 >> (self.shift + 2)
        if self.use_table and self.table is None:
            self.table = _build_add_table(self.base, self.shift)

    # -- scalar/array conversions ------------------------------------------

    def log(self, p):
        """logmath_log: ln(p)/ln(base) truncated toward zero, >> shift."""
        p = np.asarray(p, dtype=np.float64)
        out = np.full(p.shape, self.zero, dtype=np.int64)
        pos = p > 0
        v = np.trunc(np.log(np.where(pos, p, 1.0)) * self.inv_log_of_base)
        out[pos] = (v[pos].astype(np.int64)) >> self.shift
        if out.ndim == 0:
            return int(out)
        return out.astype(np.int32)

    def exp(self, x):
        x = np.asarray(x, dtype=np.int64) << self.shift
        return np.power(self.base, x.astype(np.float64))

    def ln_to_log(self, ln_p):
        """logmath_ln_to_log: natural-log value -> logmath units (float->int trunc)."""
        v = np.asarray(ln_p, dtype=np.float64) * self.inv_log_of_base
        out = np.trunc(v).astype(np.int64) >> self.shift
        if out.ndim == 0:
            return int(out)
        return out.astype(np.int32)

    def log_to_ln(self, x):
        return np.asarray(x, dtype=np.float64) * (self.log_of_base * (1 << self.shift))

    def log10_to_log(self, log10_p):
        v = np.asarray(log10_p, dtype=np.float64) * self.inv_log10_of_base
        out = np.trunc(v).astype(np.int64) >> self.shift
        if out.ndim == 0:
            return int(out)
        return out.astype(np.int32)

    def log_to_log10(self, x):
        return np.asarray(x, dtype=np.float64) * (1 << self.shift) / self.inv_log10_of_base

    # -- log-add ------------------------------------------------------------

    def add(self, x, y):
        """logmath_add for positive-log (int) values, vectorized."""
        x = np.asarray(x, dtype=np.int64)
        y = np.asarray(y, dtype=np.int64)
        r = np.maximum(x, y)
        d = np.abs(x - y)
        tbl = self.table
        idx = np.minimum(d, len(tbl) - 1)
        inc = np.where(d >= len(tbl), 0, tbl[idx])
        out = np.where(x <= self.zero, y, np.where(y <= self.zero, x, r + inc))
        if out.ndim == 0:
            return int(out)
        return out.astype(np.int32)

    def fast_add_negated(self, mlx, mly):
        """fast_logmath_add on negated (cost) values; 8-bit table, no bounds checks
        beyond table length (src/tied_mgau_common.h:111-130)."""
        mlx = np.asarray(mlx, dtype=np.int64)
        mly = np.asarray(mly, dtype=np.int64)
        r = np.minimum(mlx, mly)
        d = np.abs(mlx - mly)
        tbl = self.table
        idx = np.minimum(d, len(tbl) - 1)
        out = r - tbl[idx]
        if out.ndim == 0:
            return int(out)
        return out.astype(np.int32)


_default: LogMath | None = None
_default_8b: LogMath | None = None


def default_logmath() -> LogMath:
    """The decoder-wide logmath (base 1.0001, shift 0) — cached."""
    global _default
    if _default is None:
        _default = LogMath(1.0001, 0, True)
    return _default


def senscr_logmath() -> LogMath:
    """The 8-bit shifted logmath used for senone scores (base, SENSCR_SHIFT)."""
    global _default_8b
    if _default_8b is None:
        _default_8b = LogMath(1.0001, SENSCR_SHIFT, True)
    return _default_8b


# -- float-domain helpers (device path) -------------------------------------

LN_BASE = math.log(1.0001)
INV_LN_BASE = 1.0 / LN_BASE


def ln_to_logunits(x):
    """Natural-log float value -> float32 logmath units (no quantization)."""
    return x * INV_LN_BASE


def logunits_to_ln(x):
    return x * LN_BASE
