"""Dynamic features: MFCC -> (c, d, dd) feature streams with batch CMN.

Port of `pocketsphinx_tpu.frontend.feat.compute_feats_jax` (re-design of
src/feat/feat.c feat_1s_c_d_dd_cep2feat and src/feat/cmn.c) in torch.

Feature definition for "1s_c_d_dd" (the en-us model type):
    win = 3 (FEAT_DCEP_WIN + 1)
    c (t)  = cep[t]
    d (t)  = cep[t+2] - cep[t-2]
    dd(t)  = (cep[t+3] - cep[t-1]) - (cep[t+1] - cep[t-3])
with the utterance edge-padded by `win` copies of the first/last frame
*after* CMN; the en-us svspec 0-12/13-25/26-38 splits the 39-dim vector
into 3 streams of 13, i.e. exactly (c, d, dd).
"""

from __future__ import annotations

import torch

FEAT_DCEP_WIN = 2
WIN = FEAT_DCEP_WIN + 1  # feat_window_size for 1s_c_d_dd


def compute_feats(cep, n_frames=None, cmn: str = "batch"):
    """Batched dynamic features.

    cep: [B, T, 13] float32 (padded); n_frames: [B] int valid frame
    counts (None = all T valid).  Returns [B, T, 3, 13]; frames >=
    n_frames hold edge-replicated values and must be masked downstream.
    """
    B, T, C = cep.shape
    dev = cep.device
    if n_frames is None:
        n_frames = torch.full((B,), T, dtype=torch.int32, device=dev)
    n_frames = torch.as_tensor(n_frames, device=dev)
    t_idx = torch.arange(T, device=dev)[None, :]
    valid = t_idx < n_frames[:, None]                         # [B, T]
    if cmn == "batch":
        keep = valid & (cep[:, :, 0] >= 0)
        n = torch.clamp(keep.sum(dim=1), min=1)
        mean = (cep * keep[..., None]).sum(dim=1) / n[:, None].to(cep.dtype)
        cep = cep - mean[:, None, :]
    elif cmn != "none":
        raise NotImplementedError(f"cmn={cmn!r}: only 'batch' and 'none' "
                                  f"are ported")
    # replicated-edge gather: clamping the index to [0, n_frames-1] is the
    # reference's first/last-frame padding for any per-utterance length
    last = (n_frames - 1)[:, None]

    def at(off):
        idx = torch.minimum(torch.clamp(t_idx + off, min=0), last)
        idx = idx.clamp(min=0).expand(B, T).long()
        return torch.gather(cep, 1, idx[..., None].expand(B, T, C))

    c = at(0)
    d = at(2) - at(-2)
    dd = (at(3) - at(-1)) - (at(1) - at(-3))
    return torch.stack([c, d, dd], dim=2)
