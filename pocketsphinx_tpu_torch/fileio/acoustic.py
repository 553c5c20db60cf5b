"""Acoustic-model parameter file readers (means/variances, sendump/mixw, tmat).

NumPy re-implementations of the reference loaders:
  * Gaussian codebooks  — src/ms_gauden.c:109-247 (gauden_param_read)
  * sendump             — src/ptm_mgau.c:455-660 (read_sendump)
  * mixture_weights     — src/ptm_mgau.c:663-775 (read_mixw),
                          src/ms_senone.c (senone_init for .cont. models)
  * transition matrices — src/tmat.c:132-258 (tmat_init)

All quantization/flooring behaviors are reproduced so that golden senone
score dumps from the reference can be matched bit-for-bit by the int-parity
scorer (see ops/senone.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..logmath import LogMath, SENSCR_SHIFT, MAX_NEG_MIXW, default_logmath, senscr_logmath
from .s3 import S3File


# ---------------------------------------------------------------------------
# Gaussian codebooks (means / variances)
# ---------------------------------------------------------------------------

@dataclass
class Gauden:
    """Gaussian codebook parameters.

    means/var are ragged over streams in general; for the common case of
    uniform stream widths they are dense arrays
    ``[n_mgau, n_feat, n_density, maxlen]`` with zero padding and a
    ``featlen`` vector giving per-stream true widths.

    After :meth:`precompute`:
      * ``prec``  = logmath-units of 1/(2 sigma^2)  (float64, un-truncated
        values also kept for the float path)
      * ``det``   = per-density sum of logmath_log(1/sqrt(2 pi sigma^2))
        as int (reference sums ints) — shape [n_mgau, n_feat, n_density]
    """

    n_mgau: int
    n_feat: int
    n_density: int
    featlen: np.ndarray           # [n_feat]
    means: np.ndarray             # [n_mgau, n_feat, n_density, maxlen] f32
    var: np.ndarray               # same shape (raw variances before precompute)
    # filled by precompute():
    prec: np.ndarray | None = None      # int32 logmath 1/(2var)
    det: np.ndarray | None = None       # int32 [n_mgau,n_feat,n_density]
    prec_f: np.ndarray | None = None    # float64 un-quantized 1/(2var) in logunits
    det_f: np.ndarray | None = None     # float64 un-quantized logdet in logunits

    def precompute(self, lmath: LogMath, varfloor: float):
        """gauden_dist_precompute (src/ms_gauden.c:260-305)."""
        var = self.var.astype(np.float64).copy()
        # Mask padding lanes so they contribute nothing.
        maxlen = self.means.shape[-1]
        lane = np.arange(maxlen)[None, :]
        valid = lane < self.featlen[:, None]          # [n_feat, maxlen]
        vmask = np.broadcast_to(valid[None, :, None, :], var.shape)
        var = np.where(var < varfloor, varfloor, var)
        # Per-dim int log of 1/sqrt(2 pi var), summed in int like the C loop.
        perdim_det = lmath.log(1.0 / np.sqrt(var * 2.0 * np.pi))
        perdim_det = np.where(vmask, perdim_det, 0)
        self.det = perdim_det.sum(axis=-1).astype(np.int32)
        # Note: the reference passes the *linear* value 1/(2 var) to
        # logmath_ln_to_log — it is the nat-domain exponent multiplier,
        # scaled into logmath units (src/ms_gauden.c:292-294).
        self.prec = lmath.ln_to_log(1.0 / (var * 2.0))
        self.prec = np.where(vmask, self.prec, 0).astype(np.int32)
        # Float path (no truncation): same quantities in logmath units.
        inv = 1.0 / lmath.log_of_base
        det_f = np.where(vmask, np.log(1.0 / np.sqrt(var * 2.0 * np.pi)) * inv, 0.0)
        self.det_f = det_f.sum(axis=-1)
        self.prec_f = np.where(vmask, (1.0 / (var * 2.0)) * inv, 0.0)


def read_gauden_params(path: str) -> tuple[int, int, int, np.ndarray, np.ndarray]:
    """gauden_param_read: returns (n_mgau, n_feat, n_density, featlen, data)
    with data shaped [n_mgau, n_feat, n_density, maxlen] (zero-padded)."""
    f = S3File(path)
    n_mgau = f.read_int32()
    n_feat = f.read_int32()
    n_density = f.read_int32()
    featlen = f.read(np.int32, n_feat)
    blk = int(featlen.sum())
    n = f.read_int32()
    if n != n_mgau * n_density * blk:
        raise ValueError(f"{path}: element count {n} != "
                         f"{n_mgau}x{n_density}x{blk}")
    buf = f.read(np.float32, n)
    f.verify_chksum()
    # On-disk order: [mgau][feat][density][featlen[feat]] (ragged over feat).
    maxlen = int(featlen.max())
    out = np.zeros((n_mgau, n_feat, n_density, maxlen), dtype=np.float32)
    per_mgau = int((featlen * n_density).sum())
    for m in range(n_mgau):
        off = m * per_mgau
        for j in range(n_feat):
            L = int(featlen[j])
            chunk = buf[off:off + n_density * L].reshape(n_density, L)
            out[m, j, :, :L] = chunk
            off += n_density * L
    return n_mgau, n_feat, n_density, featlen, out


def read_gauden(mean_path: str, var_path: str, varfloor: float,
                lmath: LogMath | None = None) -> Gauden:
    lmath = lmath or default_logmath()
    n_mgau, n_feat, n_density, featlen, means = read_gauden_params(mean_path)
    m2, f2, d2, fl2, var = read_gauden_params(var_path)
    if (n_mgau, n_feat, n_density) != (m2, f2, d2):
        raise ValueError("means/variances dimension mismatch")
    g = Gauden(n_mgau, n_feat, n_density, featlen, means, var)
    g.precompute(lmath, varfloor)
    return g


# ---------------------------------------------------------------------------
# Mixture weights: sendump (pre-quantized) and mixture_weights (float s3)
# ---------------------------------------------------------------------------

@dataclass
class MixtureWeights:
    """Quantized mixture weights ``mixw[n_feat, n_density, n_sen]`` (uint8,
    negated 8-bit-logmath costs, 0 = most probable), as used by the PTM and
    semi-continuous scorers."""

    mixw: np.ndarray              # [n_feat, n_density, n_sen] uint8
    n_sen: int

    @property
    def n_feat(self):
        return self.mixw.shape[0]

    @property
    def n_density(self):
        return self.mixw.shape[1]


def read_sendump(path: str, n_sen_mdef: int, n_feat: int, n_density: int,
                 nibble_mode: str = "byte") -> MixtureWeights:
    """Parse the "sendump" pre-quantized mixture-weight file
    (src/ptm_mgau.c:455-660).  Handles the optional 4-bit cluster coding.

    nibble_mode selects which scorer's 4-bit unpacking to reproduce:
    "byte" = the PTM scorer's quirk (nibble chosen by the *byte*'s low
    bit, src/ptm_mgau.c:376-378); "senone" = the semi-continuous
    scorer's senone-parity select (src/s2_semi_mgau.c:694-699, the
    classic layout: even senone -> low nibble, odd -> high)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0

    def read_i32():
        nonlocal pos
        v = int(np.frombuffer(data, np.int32, 1, pos)[0])
        pos += 4
        return v

    n = read_i32()
    do_swap = False
    if n < 1 or n > 999:
        n = int(np.int32(n).byteswap())
        do_swap = True
        if n < 1 or n > 999:
            raise ValueError(f"{path}: bad title length")

    def rd_i32():
        v = read_i32()
        return int(np.int32(v).byteswap()) if do_swap else v

    pos += n  # title string
    n = rd_i32()
    pos += n  # header string
    n_clust, n_bits = 0, 8
    n_sen, nf, nd = n_sen_mdef, n_feat, n_density
    while True:
        n = rd_i32()
        if n == 0:
            break
        s = data[pos:pos + n].split(b"\0")[0].decode("latin-1")
        pos += n
        def atoi(txt: str) -> int:
            """C atoi: leading integer or 0 (header values may be
            non-numeric strings in old sendump files)."""
            txt = txt.strip()
            n = 0
            neg = txt.startswith("-")
            for ch in txt.lstrip("+-"):
                if not ch.isdigit():
                    break
                n = n * 10 + int(ch)
            return -n if neg else n

        for key, setter in (("feature_count ", "nf"), ("mixture_count ", "nd"),
                            ("model_count ", "n_sen"), ("cluster_count ", "n_clust"),
                            ("cluster_bits ", "n_bits")):
            if s.startswith(key):
                val = atoi(s[len(key):])
                if setter == "nf":
                    nf = val
                elif setter == "nd":
                    nd = val
                elif setter == "n_sen":
                    n_sen = val
                elif setter == "n_clust":
                    n_clust = val
                else:
                    n_bits = val
    r, c = nd, n_sen
    if n_clust == 0:
        r = rd_i32()
        c = rd_i32()
    if n_clust == 15:
        n_clust = 16
    mixw_cb = None
    if n_clust:
        mixw_cb = np.frombuffer(data, np.uint8, n_clust, pos).copy()
        pos += n_clust
    step = c if n_bits == 8 else (c + 1) // 2
    raw = np.frombuffer(data, np.uint8, nf * r * step, pos).reshape(nf, r, step)
    if n_bits == 4:
        bytes_per_sen = raw[..., np.arange(c) // 2]
        if nibble_mode == "byte":
            # PTM scorer quirk: nibble selected by the *byte's* low bit
            # (src/ptm_mgau.c:377-379, "dcw = (dcw & 1) ? dcw >> 4 :
            # dcw & 0x0f").
            odd = (bytes_per_sen & 1).astype(bool)
        else:
            # semi scorer: nibble selected by senone-index parity
            # (src/s2_semi_mgau.c:694-699).
            odd = (np.arange(c) & 1).astype(bool)[None, None, :]
            odd = np.broadcast_to(odd, bytes_per_sen.shape)
        codes = np.where(odd, bytes_per_sen >> 4, bytes_per_sen & 0x0F)
        mixw = mixw_cb[codes]
    else:
        mixw = raw[..., :c].copy()
    return MixtureWeights(mixw=mixw, n_sen=c)


def read_mixw_quantized(path: str, mixwfloor: float,
                        lmath_8b: LogMath | None = None) -> MixtureWeights:
    """Read a float "mixture_weights" s3 file and quantize exactly as
    read_mixw (src/ptm_mgau.c:663-775): normalize, floor, renormalize,
    -logmath_log on the 8-bit shifted logmath, clamp to MAX_NEG_MIXW."""
    lmath_8b = lmath_8b or senscr_logmath()
    hdr, n_sen, n_feat, n_comp, pdf = _read_mixw_raw(path)
    pdf = pdf.astype(np.float64)
    s = pdf.sum(axis=-1, keepdims=True)
    pdf = np.divide(pdf, s, out=pdf, where=s > 0)
    pdf = np.maximum(pdf, mixwfloor)
    pdf /= pdf.sum(axis=-1, keepdims=True)
    q = -lmath_8b.log(pdf)
    q = np.where((q > MAX_NEG_MIXW) | (q < 0), MAX_NEG_MIXW, q).astype(np.uint8)
    # [n_sen, n_feat, n_comp] -> [n_feat, n_comp, n_sen]
    return MixtureWeights(mixw=np.ascontiguousarray(q.transpose(1, 2, 0)), n_sen=n_sen)


def read_mixw_float(path: str, mixwfloor: float) -> np.ndarray:
    """Float mixture weights (normalized+floored, linear domain)
    shaped [n_sen, n_feat, n_comp] — used by the continuous scorer's float
    path and by senone_init-equivalent loading."""
    hdr, n_sen, n_feat, n_comp, pdf = _read_mixw_raw(path)
    pdf = pdf.astype(np.float64)
    s = pdf.sum(axis=-1, keepdims=True)
    pdf = np.divide(pdf, s, out=pdf, where=s > 0)
    pdf = np.maximum(pdf, mixwfloor)
    pdf /= pdf.sum(axis=-1, keepdims=True)
    return pdf


def _read_mixw_raw(path: str):
    f = S3File(path)
    n_sen = f.read_int32()
    n_feat = f.read_int32()
    n_comp = f.read_int32()
    n = f.read_int32()
    if n != n_sen * n_feat * n_comp:
        raise ValueError(f"{path}: bad mixw array size")
    pdf = f.read(np.float32, n).reshape(n_sen, n_feat, n_comp)
    f.verify_chksum()
    return f.hdr, n_sen, n_feat, n_comp, pdf


# ---------------------------------------------------------------------------
# Transition matrices
# ---------------------------------------------------------------------------

@dataclass
class Tmat:
    """Quantized HMM transition matrices ``tp[n_tmat, n_state, n_state+1]``
    (uint8 negated >>SENSCR_SHIFT logmath costs, 255 = impossible)."""

    tp: np.ndarray

    @property
    def n_tmat(self):
        return self.tp.shape[0]

    @property
    def n_state(self):
        return self.tp.shape[1]

    def log_tp(self) -> np.ndarray:
        """Transition scores in (un-shifted) logmath units, float32;
        impossible transitions -> -inf."""
        t = -(self.tp.astype(np.float32) * (1 << SENSCR_SHIFT))
        return np.where(self.tp == 255, -np.inf, t)


def read_tmat(path: str, tpfloor: float, lmath: LogMath | None = None) -> Tmat:
    lmath = lmath or default_logmath()
    f = S3File(path)
    n_tmat = f.read_int32()
    n_src = f.read_int32()
    n_dst = f.read_int32()
    n = f.read_int32()
    if n_dst != n_src + 1 or n != n_tmat * n_src * n_dst:
        raise ValueError(f"{path}: unsupported tmat dims")
    tp = f.read(np.float32, n).reshape(n_tmat, n_src, n_dst).astype(np.float64)
    f.verify_chksum()
    # Normalize rows, floor nonzero entries, renormalize (src/tmat.c:217-224).
    s = tp.sum(axis=-1, keepdims=True)
    tp = np.divide(tp, s, out=tp, where=s > 0)
    tp = np.where((tp != 0) & (tp < tpfloor), tpfloor, tp)
    tp /= tp.sum(axis=-1, keepdims=True)
    ltp = -lmath.log(tp) >> SENSCR_SHIFT
    ltp = np.minimum(ltp, 255).astype(np.uint8)
    return Tmat(tp=ltp)


def read_lda(path: str) -> np.ndarray:
    """LDA/MLLT feature transform reader (feat_read_lda,
    src/feat/lda.c:60-140): s3 file with float32 [n_lda, m, n]; rows are
    output dimensions (SphinxTrain stores eigenvectors as row vectors).
    Returns the first transform [m, n]."""
    f = S3File(path)
    d1 = f.read_int32()
    d2 = f.read_int32()
    d3 = f.read_int32()
    n = f.read_int32()
    if n != d1 * d2 * d3:
        raise ValueError(f"{path}: bad LDA array size")
    arr = f.read(np.float32, n).reshape(d1, d2, d3)
    f.verify_chksum()
    return arr[0]
