"""Dynamic features: MFCC -> (c, d, dd) feature streams with CMN/AGC.

Port of `pocketsphinx_tpu.frontend.feat` (re-design of src/feat/feat.c
feat_1s_c_d_dd_cep2feat and src/feat/cmn.c, cmn_live.c, agc.c) in two
halves, with these names (JAX package -> port):

  * the host half, NumPy copies that the `Decoder` runs per utterance:
    `cmn_batch`, `CmnLive`, `AgcEmax`, `agc_max`, `agc_noise`,
    `compute_deltas`, `apply_cmn_agc`, `compute_feats_typed` and
    `parse_subvecs` keep their names; `compute_feats` ->
    `compute_feats_host`;
  * the batched device half: `compute_feats_jax` -> `compute_feats`
    (torch; CMN 'batch' or 'none'), and the port's own
    `compute_feats_s2_4x` (Sphinx-II's four streams, batched), chosen by
    a model's feature type through `batch_features`.

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

import numpy as np
import torch

FEAT_DCEP_WIN = 2
WIN = FEAT_DCEP_WIN + 1  # feat_window_size for 1s_c_d_dd
#: en-us's split of the 39-dim 1s_c_d_dd vector into the streams c, d, dd
EN_US_SVSPEC = "0-12/13-25/26-38"


# ---------------------------------------------------------------------------
# Host half: CMN
# ---------------------------------------------------------------------------

def cmn_batch(cep: np.ndarray, varnorm: bool = False) -> np.ndarray:
    """Batch CMN over one utterance (src/feat/cmn.c:166-233): mean over
    frames whose c0 >= 0, subtracted from every frame (all dims)."""
    keep = cep[:, 0] >= 0
    n = int(keep.sum())
    if n == 0:
        return cep.copy()
    mean = cep[keep].sum(axis=0) / np.float32(n)
    out = cep - mean.astype(cep.dtype)
    if varnorm:
        var = np.square(out[keep]).sum(axis=0)
        out = out * np.sqrt(n / var).astype(cep.dtype)
    return out


class CmnLive:
    """Running-mean CMN (src/feat/cmn_live.c): mean updated across
    utterances; ps_get_cmn/ps_set_cmn export/restore this state."""

    CMN_WIN_HWM = 800
    CMN_WIN = 500

    def __init__(self, veclen: int = 13, init_mean: np.ndarray | None = None):
        self.veclen = veclen
        self.mean = np.zeros(veclen, dtype=np.float64)
        if init_mean is not None:
            self.mean[:len(init_mean)] = init_mean
        else:
            self.mean[0] = 40.0  # historical default for c0 (cmn_live.c init)
        self.sum = self.mean * self.CMN_WIN
        self.nframe = self.CMN_WIN

    def __call__(self, cep: np.ndarray) -> np.ndarray:
        out = (cep - self.mean.astype(cep.dtype))
        self.sum += cep.sum(axis=0, dtype=np.float64)
        self.nframe += len(cep)
        if self.nframe > self.CMN_WIN_HWM:
            self.update()
        return out

    def update(self):
        """cmn_live_update: shrink the window, recompute mean."""
        if self.nframe <= 0:
            return
        self.mean = self.sum / self.nframe
        if self.nframe >= self.CMN_WIN_HWM:
            sf = self.CMN_WIN / self.nframe
            self.sum = self.sum * sf
            self.nframe = self.CMN_WIN

    def repr_string(self) -> str:
        return ",".join(f"{v:.2f}" for v in self.mean)

    def set_repr(self, s: str):
        vals = [float(x) for x in s.split(",") if x]
        self.mean[:] = 0
        self.mean[:len(vals)] = vals
        self.sum = self.mean * self.CMN_WIN
        self.nframe = self.CMN_WIN


# ---------------------------------------------------------------------------
# AGC (src/feat/agc.c) — operates on c0 (energy) only
# ---------------------------------------------------------------------------

def agc_max(cep: np.ndarray) -> np.ndarray:
    """agc_max: subtract utterance max of c0 from c0."""
    out = cep.copy()
    out[:, 0] -= cep[:, 0].max()
    return out


class AgcEmax:
    """agc_emax: estimated-max AGC — subtract a running estimate of the
    utterance c0 maximum, re-estimated across utterances EXACTLY like
    the reference (src/feat/agc.c:142-178): the estimate is the mean of
    the per-utterance observed maxima, with the history halved every 16
    utterances (obs_max_sum /= 2, obs_utt 16 -> 8); an utterance only
    contributes if some frame raised obs_max (obs_frame flag)."""

    def __init__(self, init: float = 0.0):
        # agc_init calloc's the struct: max = obs_max = 0
        self.max_est = init         # agc->max (agc_emax_set)
        self.obs_max = 0.0
        self.obs_frame = False
        self.obs_max_sum = 0.0
        self.obs_utt = 0

    def __call__(self, cep: np.ndarray) -> np.ndarray:
        out = cep.copy()
        out[:, 0] -= self.max_est
        for v in cep[:, 0]:
            if float(v) > self.obs_max:
                self.obs_max = float(v)
                self.obs_frame = True
        return out

    def update(self):
        """agc_emax_update (src/feat/agc.c:159-178)."""
        if self.obs_frame:
            self.obs_max_sum += self.obs_max
            self.obs_utt += 1
            self.max_est = self.obs_max_sum / self.obs_utt
            if self.obs_utt == 16:
                self.obs_max_sum /= 2
                self.obs_utt = 8
        self.obs_frame = False
        self.obs_max = -1000.0


def agc_noise(cep: np.ndarray, noise_thresh: float = 2.0) -> np.ndarray:
    """agc_noise: subtract the mean c0 of the quietest frames (noise
    level) from c0 (src/feat/agc.c agc_noise)."""
    out = cep.copy()
    c0 = cep[:, 0]
    if len(c0):
        floor = c0.min() + noise_thresh
        quiet = c0[c0 <= floor]
        out[:, 0] -= quiet.mean() if len(quiet) else c0.min()
    return out


# ---------------------------------------------------------------------------
# Dynamic features
# ---------------------------------------------------------------------------

def compute_deltas(cep: np.ndarray) -> np.ndarray:
    """[T, 13] (already CMN'd) -> [T, 3, 13] streams (c, d, dd) with
    replicated edge padding, exactly as feat_s2mfc2feat_block_utt."""
    T = cep.shape[0]
    pad = np.concatenate([np.repeat(cep[:1], WIN, axis=0), cep,
                          np.repeat(cep[-1:], WIN, axis=0)], axis=0)
    # index i in padded array corresponds to output frame i - WIN
    c = pad[WIN:WIN + T]
    d = pad[WIN + 2:WIN + 2 + T] - pad[WIN - 2:WIN - 2 + T]
    dd = ((pad[WIN + 3:WIN + 3 + T] - pad[WIN - 1:WIN - 1 + T])
          - (pad[WIN + 1:WIN + 1 + T] - pad[WIN - 3:WIN - 3 + T]))
    return np.stack([c, d, dd], axis=1)


def apply_cmn_agc(cep: np.ndarray, cmn: str = "batch",
                  cmn_state: CmnLive | None = None, agc: str = "none",
                  varnorm: bool = False,
                  agc_state: "AgcEmax | None" = None) -> np.ndarray:
    cep = np.asarray(cep, dtype=np.float32)
    if cmn in ("batch", "current"):      # "current" = legacy name
        cep = cmn_batch(cep, varnorm)
    elif cmn in ("live", "prior"):
        cep = (cmn_state or CmnLive(cep.shape[1]))(cep)
    if agc == "max":
        cep = agc_max(cep)
    elif agc == "emax":
        cep = (agc_state or AgcEmax())(cep)
    elif agc == "noise":
        cep = agc_noise(cep)
    return cep


def compute_feats_host(cep: np.ndarray, cmn: str = "batch",
                  cmn_state: CmnLive | None = None,
                  agc: str = "none", varnorm: bool = False) -> np.ndarray:
    """Default dynamic-feature pipeline [T,13] -> [T,3,13] float32
    (1s_c_d_dd with the en-us svspec split)."""
    cep = apply_cmn_agc(cep, cmn, cmn_state, agc, varnorm)
    return compute_deltas(cep)


def compute_feats_typed(cep: np.ndarray, feat_type: str = "1s_c_d_dd",
                        svspec: str | None = None, cmn: str = "batch",
                        cmn_state: CmnLive | None = None,
                        agc: str = "none", varnorm: bool = False,
                        lda: np.ndarray | None = None,
                        ldadim: int = 0):
    """Feature computation dispatch by -feat type (feat_init,
    src/feat/feat.c:705-800).  Returns ([T, n_stream, max_len] float32
    zero-padded, featlen list)."""
    cep = apply_cmn_agc(cep, cmn, cmn_state, agc, varnorm)
    T, C = cep.shape
    if feat_type in ("1s_c_d_dd", "1s_c_d_ld_dd", "s3_1x39",
                     "1s_c_d", "cep_dcep", "1s_c", "cep"):
        if feat_type == "1s_c_d_ld_dd":
            # c | d(+-2) | long d(+-4) | dd (feat_1s_c_d_ld_dd_cep2feat,
            # src/feat/feat.c:625-680); window_size 4, edges replicated
            win = 4
            pad = np.concatenate([np.repeat(cep[:1], win, 0), cep,
                                  np.repeat(cep[-1:], win, 0)], axis=0)

            def at(off):
                return pad[win + off:win + off + T]
            vec = np.concatenate(
                [at(0), at(2) - at(-2), at(4) - at(-4),
                 (at(3) - at(-1)) - (at(1) - at(-3))],
                axis=1).astype(np.float32)      # [T, 4*C]
        elif feat_type in ("1s_c_d", "cep_dcep"):
            # c | d(+-2) (feat_s3_cep_dcep, src/feat/feat.c:702)
            st = compute_deltas(cep)
            vec = st[:, :2].reshape(T, -1)      # [T, 2*C]
        elif feat_type in ("1s_c", "cep"):
            vec = cep.astype(np.float32)[:]     # [T, C]
        elif feat_type == "s3_1x39":
            # c1-12, d1-12, c0 dc0 ddc0, dd1-12 (feat_s3_1x39_cep2feat)
            st = compute_deltas(cep)            # [T,3,13]
            c, d, dd = st[:, 0], st[:, 1], st[:, 2]
            vec = np.concatenate(
                [c[:, 1:], d[:, 1:], np.stack(
                    [c[:, 0], d[:, 0], dd[:, 0]], axis=1), dd[:, 1:]],
                axis=1)
        else:
            st = compute_deltas(cep)
            vec = st.reshape(T, -1)             # [T, 39] c/d/dd
        if lda is not None:
            # feat_lda_transform (src/feat/lda.c): single-stream only;
            # rows of the matrix are output dimensions
            dim = ldadim if ldadim and ldadim <= lda.shape[0] \
                else lda.shape[0]
            vec = (vec @ lda.T[:, :dim]).astype(np.float32)
        if svspec:
            streams = parse_subvecs(svspec)
            maxlen = max(len(s) for s in streams)
            out = np.zeros((T, len(streams), maxlen), np.float32)
            for i, idx in enumerate(streams):
                out[:, i, :len(idx)] = vec[:, idx]
            return out, [len(s) for s in streams]
        return vec[:, None, :], [vec.shape[1]]
    if feat_type == "s2_4x":
        # Sphinx-II 4-stream (feat_s2_4x_cep2feat, src/feat/feat.c:425):
        # cep c1-12 | dcep short(+-2)+long(+-4) | pow c0,dc0,ddc0 | ddcep
        if C != 13:
            raise ValueError("s2_4x features require cepsize 13")
        win = 4
        pad = np.concatenate([np.repeat(cep[:1], win, 0), cep,
                              np.repeat(cep[-1:], win, 0)], axis=0)

        def at(off):
            return pad[win + off:win + off + T]
        c = at(0)
        d_s = at(2) - at(-2)
        d_l = at(4) - at(-4)
        dd = (at(3) - at(-1)) - (at(1) - at(-3))
        out = np.zeros((T, 4, 24), np.float32)
        out[:, 0, :12] = c[:, 1:]
        out[:, 1, :12] = d_s[:, 1:]
        out[:, 1, 12:24] = d_l[:, 1:]
        out[:, 2, 0] = c[:, 0]
        out[:, 2, 1] = d_s[:, 0]
        out[:, 2, 2] = dd[:, 0]
        out[:, 3, :12] = dd[:, 1:]
        return out, [12, 24, 3, 12]
    raise ValueError(f"unsupported feature type {feat_type!r}")


def parse_subvecs(spec: str) -> list[np.ndarray]:
    """Subvector spec parser (parse_subvecs, src/feat/feat.c:169-230):
    streams separated by '/', each a comma list of indices or a-b ranges."""
    streams = []
    for part in spec.split("/"):
        idx: list[int] = []
        for item in part.split(","):
            if "-" in item:
                a, b = item.split("-")
                idx.extend(range(int(a), int(b) + 1))
            elif item:
                idx.append(int(item))
        streams.append(np.asarray(idx, dtype=np.int64))
    return streams


# ---------------------------------------------------------------------------
# Batched device half
# ---------------------------------------------------------------------------

def _batch_cmn(cep, n_frames, cmn: str):
    """cep [B, T, C] less each utterance's mean over its frames (< its
    n_frames) whose c0 >= 0 (CMN 'batch'), or as it is ('none'); and the
    clamped gather `at(off)` [B, T, C] of frame t + off, the index held
    to [0, n_frames - 1]: the reference's first/last-frame padding for
    any per-utterance length."""
    B, T, C = cep.shape
    dev = cep.device
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
    last = (n_frames - 1)[:, None]

    def at(off):
        idx = torch.minimum(torch.clamp(t_idx + off, min=0), last)
        idx = idx.clamp(min=0).expand(B, T).long()
        return torch.gather(cep, 1, idx[..., None].expand(B, T, C))
    return at


def _frames(cep, n_frames):
    B, T, _ = cep.shape
    if n_frames is None:
        return torch.full((B,), T, dtype=torch.int32, device=cep.device)
    return torch.as_tensor(n_frames, device=cep.device)


def compute_feats(cep, n_frames=None, cmn: str = "batch"):
    """Batched dynamic features.

    cep: [B, T, 13] float32 (padded); n_frames: [B] int valid frame
    counts (None = all T valid).  Returns [B, T, 3, 13]; frames >=
    n_frames hold edge-replicated values and must be masked downstream.
    """
    at = _batch_cmn(cep, _frames(cep, n_frames), cmn)
    c = at(0)
    d = at(2) - at(-2)
    dd = (at(3) - at(-1)) - (at(1) - at(-3))
    return torch.stack([c, d, dd], dim=2)


def compute_feats_s2_4x(cep, n_frames=None, cmn: str = "batch"):
    """Batched Sphinx-II features (`compute_feats_typed`'s "s2_4x",
    feat_s2_4x_cep2feat, src/feat/feat.c:425): the four streams

        0 (12): c1-12
        1 (24): d1-12 = c(t+2) - c(t-2), then the long d1-12 =
                c(t+4) - c(t-4)
        2 (3):  c0, d0, dd0
        3 (12): dd1-12 = (c(t+3) - c(t-1)) - (c(t+1) - c(t-3))

    after CMN, each utterance's first and last frames repeated past its
    ends.  cep: [B, T, 13] float32 (padded); n_frames: [B] (None = all
    T valid).  Returns [B, T, 4, 24], the lanes past a stream's width
    zero; frames >= n_frames hold edge-replicated values."""
    B, T, C = cep.shape
    if C != 13:
        raise ValueError(f"s2_4x features take 13 cepstra, not {C}")
    at = _batch_cmn(cep, _frames(cep, n_frames), cmn)
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


def batch_features(feat_type: str = "1s_c_d_dd", svspec: str | None = None):
    """The batched feature function `(cep, n_frames, cmn) -> [B, T, F,
    L]` of a model's feature type and stream split (its `feat.params`'
    `-feat` and `-svspec`): `compute_feats` for en-us's 1s_c_d_dd split
    into c, d and dd (`EN_US_SVSPEC`, or no split given),
    `compute_feats_s2_4x` for s2_4x.  Any other type fails by name."""
    if feat_type == "1s_c_d_dd" and svspec in (None, EN_US_SVSPEC):
        return compute_feats
    if feat_type == "s2_4x" and svspec is None:
        return compute_feats_s2_4x
    raise ValueError(f"the batched features take 1s_c_d_dd (-svspec "
                     f"{EN_US_SVSPEC}) or s2_4x, not -feat {feat_type} "
                     f"-svspec {svspec}")
