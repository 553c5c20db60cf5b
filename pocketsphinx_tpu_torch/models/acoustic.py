"""Acoustic model bundle and batched senone scoring in torch.

Port of `pocketsphinx_tpu.models.acoustic`: `AcousticModel` (NumPy host
copy: mdef + tmat + Gaussians + mixture weights, with the dense scoring
operands) and `senone_scores_jax` as `senone_scores`.

Instead of active-senone lists and per-codebook top-N shortlists (the
reference's acmod_t + ps_mgaufuncs_t stack, src/acmod.c, src/ptm_mgau.c,
src/ms_mgau.c, src/s2_semi_mgau.c), every senone is scored every frame
as a GEMM + log-sum-exp.

Score units: float32 "shifted logmath units" == the reference's int16
senone-score scale (log base 1.0001, >> SENSCR_SHIFT).  0 = per-frame
best, larger = worse (cost).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from .. import on_device
from ..config import PARAMS, parse_args_file
from ..fileio import (read_bin_mdef, read_gauden, read_sendump,
                      read_mixw_quantized, read_tmat, BinMdef, Gauden,
                      MixtureWeights, Tmat)
from ..logmath import SENSCR_SHIFT

#: the `feat.params` settings the features of a model take (with the
#: configuration's defaults where its directory gives none)
FEAT_KEYS = ("feat", "svspec", "cmn")
LN_BASE = math.log(1.0001)
# one shifted score unit, in nats
UNIT_NATS = LN_BASE * (1 << SENSCR_SHIFT)


@dataclass
class AcousticModel:
    """Loaded acoustic model with precomputed scoring operands."""

    mdef: BinMdef
    gauden: Gauden
    mixw: MixtureWeights
    tmat: Tmat
    model_type: str  # "ptm" | "cont" | "semi"
    #: the feature settings of the model directory's `feat.params`
    #: (`FEAT_KEYS`: -feat, -svspec, -cmn), the defaults for a key it
    #: lacks; the batch path computes the features `feat` and `svspec`
    #: name (`frontend.feat.batch_features`)
    feat_params: dict = field(default_factory=lambda: {
        k: PARAMS[k][1] for k in FEAT_KEYS})

    @classmethod
    def load(cls, hmm_dir: str, varfloor: float = 1e-4,
             mixwfloor: float = 1e-7, tmatfloor: float = 1e-4,
             sendump: str | None = None) -> "AcousticModel":
        """Load from a model directory (mdef/means/variances/
        transition_matrices + sendump or mixture_weights, and the
        feature settings of its feat.params)."""
        p = lambda f: os.path.join(hmm_dir, f)  # noqa: E731
        mdef = read_bin_mdef(p("mdef"))
        g = read_gauden(p("means"), p("variances"), varfloor)
        # model type as acmod_init_am (src/acmod.c:62-170): one codebook
        # per CI phone => PTM; one in total => semi; one per senone =>
        # fully continuous
        if g.n_mgau == mdef.n_ciphone:
            mtype = "ptm"
        elif g.n_mgau == 1:
            mtype = "semi"
        else:
            mtype = "cont"
        if sendump is None and os.path.isfile(p("sendump")):
            sendump = p("sendump")
        if sendump:
            mixw = read_sendump(sendump, mdef.n_sen, g.n_feat, g.n_density,
                                nibble_mode=("senone" if mtype == "semi"
                                             else "byte"))
        else:
            mixw = read_mixw_quantized(p("mixture_weights"), mixwfloor)
        tmat = read_tmat(p("transition_matrices"), tmatfloor)
        params = (dict(parse_args_file(p("feat.params")))
                  if os.path.isfile(p("feat.params")) else {})
        return cls(mdef=mdef, gauden=g, mixw=mixw, tmat=tmat,
                   model_type=mtype,
                   feat_params={k: params.get(k, PARAMS[k][1])
                                for k in FEAT_KEYS})

    # -- derived arrays ------------------------------------------------------

    @cached_property
    def sen2cb(self) -> np.ndarray:
        """Senone -> codebook map [n_sen]."""
        if self.model_type == "ptm":
            return self.mdef.sen2cimap.astype(np.int32)
        if self.model_type == "semi":
            return np.zeros(self.mdef.n_sen, dtype=np.int32)
        return np.arange(self.mdef.n_sen, dtype=np.int32)

    @cached_property
    def n_sen(self) -> int:
        return self.mdef.n_sen

    @cached_property
    def scoring_arrays(self) -> dict:
        """Dense scoring operands (host NumPy), identical to the JAX
        package's: the density exponent  det - sum_i (x_i-mu_i)^2 prec_i
        is decomposed as  const[cb,f,d] - (x2 . prec - 2 x . muprec)
        with const = det - sum mu^2 prec, in shifted units."""
        g = self.gauden
        prec = g.prec.astype(np.float64)
        mu = g.means.astype(np.float64)
        muprec = mu * prec
        const = g.det.astype(np.float64) - (mu * muprec).sum(-1)
        s = 1.0 / (1 << SENSCR_SHIFT)
        return {
            "prec": (prec * s).astype(np.float32),      # [CB,F,D,L]
            "muprec": (muprec * s).astype(np.float32),  # [CB,F,D,L]
            "const": (const * s).astype(np.float32),    # [CB,F,D]
            "w_lin": np.exp(-self.mixw.mixw.astype(np.float64)
                            * UNIT_NATS).astype(np.float32),  # [F,D,S]
            "mixw_cost": self.mixw.mixw.astype(np.float32),   # [F,D,S]
            "sen2cb": self.sen2cb,
        }

    @cached_property
    def cb_groups(self) -> dict:
        """Senones grouped by codebook, padded to a uniform size:
        sen_pad [CB, Smax] senone ids (fill = 0 masked), mask [CB, Smax]."""
        cb = self.sen2cb
        n_cb = self.gauden.n_mgau
        groups = [np.nonzero(cb == c)[0] for c in range(n_cb)]
        smax = max(len(gr) for gr in groups)
        smax = (smax + 127) & ~127
        sen_pad = np.zeros((n_cb, smax), dtype=np.int32)
        mask = np.zeros((n_cb, smax), dtype=bool)
        for c, gr in enumerate(groups):
            sen_pad[c, :len(gr)] = gr
            mask[c, :len(gr)] = True
        return {"sen_pad": sen_pad, "mask": mask, "smax": smax}

    def scoring_tensors(self, device) -> dict:
        """`scoring_arrays` + `cb_groups` as tensors on `device` (cached
        per device)."""
        from ..convert import scoring_tensors
        cache = self.__dict__.setdefault("_scoring_tensors", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = scoring_tensors(self.scoring_arrays,
                                         self.cb_groups, device)
        return cache[key]

    def scoring_shards(self, devices) -> list:
        """The scoring tensors split over a "model" group of devices
        (`convert.split_scoring_tensors`; cached per group)."""
        from ..convert import split_scoring_tensors
        cache = self.__dict__.setdefault("_scoring_tensors", {})
        key = tuple(str(torch.device(d)) for d in devices)
        if key not in cache:
            cache[key] = split_scoring_tensors(self.scoring_arrays,
                                               self.cb_groups, devices)
        return cache[key]


def senone_scores(model, feats, topn: int = 4,
                  time_chunk: int | None = None, ds: int = 1):
    """Batched senone scoring: feats [B, T, F, L] float32 ->
    costs [B, T, n_sen] float32 (shifted units, 0 = per-frame best).

    `model` is the tensor dict of `convert.scoring_tensors` (on the
    device the scoring runs on), or the list of a "model" group's dicts
    (`convert.split_scoring_tensors`): each device then scores its
    codebooks or senone slots, the per-stream norm and the per-frame max
    are taken over the whole group (exact max reductions), and the costs
    come back on the first device.  Port of `senone_scores_jax`:

    ds > 1: frame GMM downsampling (the reference's -ds): every ds-th
    frame is scored and held for the following ds-1 frames.
    time_chunk: score T in chunks of this many frames, bounding the
    [B, chunk, CB, F, Smax] mixture intermediate.
    topn > 0: per-(codebook, stream) top-N density shortlist as a mask
    on the dense product (only the N-th value is read, so tie order does
    not matter); topn == 0: exact log-sum-exp over all densities.
    Products run in full float32 (TF32 is off, see the package init)."""
    shards = model if isinstance(model, list) else [model]
    lead = shards[0]["prec"].device
    feats = torch.as_tensor(feats, device=lead)
    if ds > 1:
        T = feats.shape[1]
        out = senone_scores(model, feats[:, ::ds], topn=topn,
                            time_chunk=time_chunk)
        return torch.repeat_interleave(out, ds, dim=1)[:, :T]
    if time_chunk:
        T = feats.shape[1]
        return torch.cat([senone_scores(model, feats[:, t:t + time_chunk],
                                        topn=topn)
                          for t in range(0, T, time_chunk)], dim=1)

    x = feats.to(torch.float32)                     # [B, T, F, L]
    B, T = x.shape[:2]
    dens = []
    for sh in shards:
        with on_device(sh["prec"].device):
            xs = x.to(sh["prec"].device, non_blocking=True)
            x2 = xs * xs
            quad = torch.einsum("btfl,cfdl->btcfd", x2, sh["prec"])
            cross = torch.einsum("btfl,cfdl->btcfd", xs, sh["muprec"])
            dens.append(sh["const"][None, None] - quad + 2.0 * cross)
    # per-stream normalization (best over codebooks), clamped at
    # -MAX_NEG_ASCR like ptm_mgau_codebook_norm
    norm = dens[0].amax(dim=(2, 4), keepdim=True)   # [B, T, 1, F, 1]
    for d in dens[1:]:
        norm = torch.maximum(norm, d.amax(dim=(2, 4), keepdim=True)
                             .to(lead, non_blocking=True))
    parts = []
    for sh, d in zip(shards, dens):
        with on_device(d.device):
            dnorm = torch.clamp(d - norm.to(d.device, non_blocking=True),
                                min=-96.0)
            E = torch.exp(dnorm * UNIT_NATS)        # [B, T, CB, F, D]
            D = E.shape[-1]
            if topn and topn < D:
                kth = torch.topk(dnorm, topn, dim=-1).values[..., -1:]
                E = torch.where(dnorm >= kth, E, torch.zeros_like(E))
            if "Wg" not in sh:
                # fully continuous (one codebook per senone): the
                # mixture sum is diagonal in the codebook axis
                P = torch.einsum("btcfd,fdc->btcf", E, sh["w_lin"])
                fden = torch.log(torch.clamp(P, min=1e-37)) / UNIT_NATS
                part = fden.sum(dim=-1)             # [B, T, S]
            else:
                # block-diagonal mixture product over codebook groups
                P = torch.einsum("btcfd,cfds->btcfs", E, sh["Wg"])
                fden = torch.log(torch.clamp(P, min=1e-37)) / UNIT_NATS
                part = fden.sum(dim=3)              # [B, T, CB, Smax]
        parts.append(part.to(lead, non_blocking=True))
    axis = 3 if shards[0].get("axis") == "slot" else 2
    goodness = parts[0] if len(parts) == 1 else torch.cat(parts, axis)
    if "Wg" in shards[0]:
        # back to senone order: each real senone sits at exactly one
        # group slot; a senone in no group reads the appended -inf column
        grouped = goodness.reshape(B, T, -1)        # [B, T, CB*Smax]
        grouped = torch.cat([grouped,
                             grouped.new_full((B, T, 1), -math.inf)], dim=-1)
        goodness = grouped[..., shards[0]["sen_slot"]]   # [B, T, S]
    return goodness.amax(dim=-1, keepdim=True) - goodness
