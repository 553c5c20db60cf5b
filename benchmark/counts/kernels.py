"""Bytes and operations of the scan's kernels and the scoring, from
shapes alone, and the least time they allow on one H100.

`fan_bytes`, the chain count (`chain_bytes`, as `check_chain` counts a
bucket's inputs and outputs) and `bound_s` are frozen copies of
`chip_smoke.py`'s `fan_bytes`, `check_chain` and `bound_ms` at commit
877b0e812f03b9328e7049cc92b93a2d85380b01 (seconds here, not ms), since
widened to any number of HMM states (the fan's count, which took 3) and
to streams of unequal widths (the scoring's).  The shapes come from the
reference's decoder (`benchmark.reference.psref`), which lays the tables
out from the configuration alone, so the counts read the same work
whatever the port does with it.
"""

from __future__ import annotations

#: H100 SXM, NVIDIA's data sheet (dense rates, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time: bytes over the memory rate, or float32 operations
    over the float32 rate, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def fan_bytes(B: int, NRC: int, W: int, LP: int, NST: int = 3) -> int:
    """Bytes one frame's word-final step (the fan) over W words must
    move, counted without the carry's pads: the S/TF/CX planes
    [B, NST, NRC, W] read and written, the exit plane [B, NRC, W],
    pred/ptf/pcx and the exits [B, W], the senone costs pre
    [B, NST, NRC, LP], each word's lp and its NST (NST + 1) transition
    rows, and the [B] maximum."""
    return 4 * (6 * NST * B * NRC * W + B * NRC * W + 6 * B * W
                + NST * B * NRC * LP + (1 + NST * (NST + 1)) * W + B)


def fan_ops(B: int, NRC: int, W: int, NST: int = 3) -> int:
    return 6 * NST * B * NRC * W


def chain_bytes(B: int, NST: int, buckets) -> int:
    """Bytes one frame's chain step must move over `buckets`, each
    (D, W, RF, NFD) with RF = 0 for a bucket without first-phone
    variants: each input read once (S, TF, CTX, pre [B, NST, D, W], tp
    [NST (NST + 1), D, W], the first-depth mask [D, W]; with variants
    VAR [B, NST, W], prevd [B, NST, RF, NFD], fd_idx and nv [W]) and
    each output written once (the planes, VAR and the three exit rows)."""
    n = 0
    for D, W, RF, NFD in buckets:
        n += 16 * B * NST * D * W + 4 * NST * (NST + 1) * D * W + D * W
        if RF:
            n += 4 * B * NST * W + 4 * B * NST * RF * NFD + 8 * W
        n += 4 * B * (3 * NST * D * W + NST * W + 3 * W)
    return n


def chain_ops(B: int, NST: int, buckets) -> int:
    return sum(12 * B * NST * D * W for D, W, _, _ in buckets)


def transitions_bytes(B: int, nE: int, NRC: int, K: int) -> int:
    """The part of the word-transition block's bytes that does not depend
    on the data: the top-K exits (four [B, K] rows and the [B, NRC, K]
    exit planes), the [E] column tables and the seven [B, E] outputs.
    The LM rows that the exits' contexts select are left out, so this
    is a lower count."""
    return 16 * B * K + 4 * B * NRC * K + 26 * nE + 40 * B * nE


def gmm_scoring_flops(B: int, n_cb: int, featlen, n_density: int,
                      n_sen: int) -> int:
    """Float32 operations of one frame's scoring of B rows as products
    (PTM, semi-continuous, and continuous with n_cb = n_sen): the
    Gaussians' quadratic and cross terms ([1, L_f] x [L_f, CB x D] per
    stream f, at its true width L_f, twice) and each senone's mixture
    over its codebook's densities ([F, D] x [D, S])."""
    return B * (4 * sum(featlen) * n_cb * n_density
                + 2 * len(featlen) * n_density * n_sen)


def step_shapes(dec) -> dict:
    """The shapes the counts take, from a reference decoder
    (`psref.search.ngram_fused.NgramFusedDecoder`)."""
    buckets = [(c.D, c.Wb, c.RF, c.senid_first_d.shape[-1])
               for c in dec.chains]
    buckets += [(c.D, c.Wb, 0, 0) for c in dec.ci_chains]
    g = dec.am.gauden
    return dict(NRC=int(dec.n_rcp), W=int(dec.n_multi),
                LP=int(dec.senid_fin_d.shape[-1]), NST=int(dec.NST),
                nE=int(dec.nE), K=int(dec.K), buckets=buckets,
                n_cb=int(g.n_mgau), featlen=[int(x) for x in g.featlen],
                n_density=int(g.n_density), n_sen=int(dec.am.n_sen))


def step_counts(shapes: dict, B: int) -> dict:
    """Per batch-frame step of B rows: bytes and operations of the fan,
    the chain and the transitions, the scoring's operations over the
    model's own codebooks and stream widths, and the least time of the
    whole step (the scoring at the float32 rate plus the search's bytes
    at the memory rate)."""
    s = shapes
    fan = fan_bytes(B, s["NRC"], s["W"], s["LP"], s["NST"])
    chain = chain_bytes(B, s["NST"], s["buckets"])
    tr = transitions_bytes(B, s["nE"], s["NRC"], s["K"])
    flops = gmm_scoring_flops(B, s["n_cb"], s["featlen"], s["n_density"],
                              s["n_sen"])
    return dict(
        fan_bytes=fan,
        fan_s=bound_s(fan, fan_ops(B, s["NRC"], s["W"], s["NST"])),
        chain_bytes=chain,
        chain_s=bound_s(chain, chain_ops(B, s["NST"], s["buckets"])),
        transitions_bytes=tr, scoring_flops=flops,
        step_s=flops / F32_OPS_PER_S + (fan + chain + tr) / HBM_BYTES_PER_S)
