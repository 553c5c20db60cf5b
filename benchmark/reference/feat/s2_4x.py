"""The reference's features of `feat` "s2_4x", Sphinx-II's four streams
(feat_s2_4x_cep2feat, src/feat/feat.c:425), batched in plain torch:

    stream 0 (12): c1-12
    stream 1 (24): d1-12 = c(t+2) - c(t-2), then the long d1-12 =
                   c(t+4) - c(t-4)
    stream 2 (3):  c0, d0, dd0
    stream 3 (12): dd1-12 = (c(t+3) - c(t-1)) - (c(t+1) - c(t-3))

each utterance's first and last frames repeated past its ends, after
CMN.  The streams sit in [B, T, 4, 24], the lanes past a stream's width
zero; the frames past an utterance's end are computed over its cepstra
repeated, as the batched 1s_c_d_dd features' are, and read no padding."""

import torch

#: the streams' widths over 13 cepstra
FEATLEN = [12, 24, 3, 12]


def features(cep, n_frames, cmn: str):
    """cep [B, T, 13] (padded), n_frames [B], CMN "batch" (each
    utterance's mean over its frames whose c0 >= 0, src/feat/cmn.c) or
    "none" -> [B, T, 4, 24]."""
    B, T, C = cep.shape
    if C != 13:
        raise ValueError(f"s2_4x features take 13 cepstra, not {C}")
    dev = cep.device
    n_frames = torch.as_tensor(n_frames, device=dev)
    t_idx = torch.arange(T, device=dev)[None, :]
    if cmn == "batch":
        keep = (t_idx < n_frames[:, None]) & (cep[:, :, 0] >= 0)
        n = torch.clamp(keep.sum(dim=1), min=1)
        mean = (cep * keep[..., None]).sum(dim=1) / n[:, None].to(cep.dtype)
        cep = cep - mean[:, None, :]
    elif cmn != "none":
        raise ValueError(f"cmn_batch = {cmn!r}: 'batch' or 'none'")
    last = (n_frames - 1)[:, None]

    def at(off):
        idx = torch.minimum(torch.clamp(t_idx + off, min=0), last)
        idx = idx.clamp(min=0).expand(B, T).long()
        return torch.gather(cep, 1, idx[..., None].expand(B, T, C))

    c = at(0)
    d = at(2) - at(-2)
    d_long = at(4) - at(-4)
    dd = (at(3) - at(-1)) - (at(1) - at(-3))
    out = cep.new_zeros((B, T, 4, 24))
    out[:, :, 0, :12] = c[..., 1:]
    out[:, :, 1, :12] = d[..., 1:]
    out[:, :, 1, 12:] = d_long[..., 1:]
    out[:, :, 2, :3] = torch.stack([c[..., 0], d[..., 0], dd[..., 0]], -1)
    out[:, :, 3, :12] = dd[..., 1:]
    return out
