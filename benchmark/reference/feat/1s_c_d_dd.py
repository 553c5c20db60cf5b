"""The reference's features of `feat` "1s_c_d_dd" (pocketsphinx's en-us
type, src/feat/feat.c feat_1s_c_d_dd_cep2feat, split by the en-us svspec
into the three streams c, d and dd): the frozen copy's batched
`compute_feats`."""

from benchmark.reference.psref.frontend.feat import compute_feats

#: the streams' widths over 13 cepstra
FEATLEN = [13, 13, 13]


def features(cep, n_frames, cmn: str):
    """cep [B, T, 13] (padded), n_frames [B], CMN "batch" or "none" ->
    [B, T, 3, 13]."""
    return compute_feats(cep, n_frames, cmn=cmn)
