"""Allphone (phoneme) decoding: loop over phone HMMs with an optional
phone-bigram LM (src/allphone_search.c re-design).

Port of `pocketsphinx_tpu.search.allphone`.  The networks (`_build_*`)
and `_backtrace` are host code, copied; the per-frame step is torch on
the search's device (CUDA unless `device="cpu"`), run as captured
16-frame chunks (`base.ChunkGraph`; `graph=False`: frame by frame), and
its exit records are copied to the host once per utterance.

With -allphone_ci (default), the network is the CI phone set; each frame
every phone HMM updates densely, phone transitions apply the phone LM
bigram (phone names as LM "words") or a uniform phone-insertion penalty,
and dense per-frame exit records feed the host backtrace into a phone
segmentation (phseg_t equivalent).

With -allphone_ci no, the network is the reference's PHMM graph
(phmm_build, src/allphone_search.c:220-316): one node per unique
(ci, ssid, tmat) among all triphones, with left/right-context CI bitmaps
(fillers mapped to every filler).  The transition factors through CI
classes -- node p -> node q is allowed iff rc[p] contains ci(q) and lc[q]
contains ci(p), so a frame's update is two dense [N, n_ci] masked
reductions around the [n_ci, n_ci] bigram matrix: a max per source class
(`scatter_reduce` "amax" onto a -inf [n_ci, n_ci], the JAX
`segment_max`, then clamped at NEG_INF) and a first-max per node.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..lm.ngram import NgramModel
from ..models.acoustic import AcousticModel, UNIT_NATS
from ..ops.hmm import hmm_step, out_meta, propagate_meta
from .base import DeviceSearch, host_to
from .ngram_fused import Seg

NEG_INF = -1e30
SHIFT = 1 << 10


class AllphoneDecoder(DeviceSearch):
    def __init__(self, am: AcousticModel, lm: NgramModel | None = None,
                 ci_only: bool = True, pip: float = 1.0, device=None,
                 graph: bool = True):
        self.device = resolve_device(device)
        self.graph = graph
        self.am = am
        self.mdef = am.mdef
        self.lm = lm
        self.ci_only = ci_only
        self.pip = math.log(pip) / UNIT_NATS
        self._build_bigram()
        if ci_only:
            self._build_ci()
        else:
            self._build_tri()
        self.tables = self._device_tables(self.device)

    def rebuild(self):
        """Nothing: the network does not depend on the dictionary (the
        JAX search has no `_build`)."""

    def _build_bigram(self):
        """[n_ci, n_ci] phone-bigram transition matrix in shifted units."""
        mdef = self.mdef
        nci = mdef.n_ciphone
        if self.lm is not None:
            lmw = np.full(nci, -1, np.int32)
            for p in range(nci):
                lmw[p] = self.lm.wid(mdef.ciname[p])
            M = np.zeros((nci, nci), np.float32)
            for a in range(nci):
                if lmw[a] >= 0:
                    row = self.lm.successor_row((int(lmw[a]),))
                    M[a] = np.where(lmw >= 0,
                                    row[np.maximum(lmw, 0)],
                                    row.min())
                else:
                    uni = self.lm.successor_row(())
                    M[a] = np.where(lmw >= 0, uni[np.maximum(lmw, 0)],
                                    uni.min())
            self.M = M / SHIFT + self.pip
        else:
            self.M = np.full((nci, nci), self.pip, np.float32)

    def _build_ci(self):
        mdef = self.mdef
        nci = mdef.n_ciphone
        self.n_node = nci
        self.node_ci = np.arange(nci, dtype=np.int32)
        self.senid = mdef.sseq[mdef.phone_ssid[:nci]].astype(np.int32)
        tpc = self.am.tmat.tp[mdef.phone_tmat[:nci]].astype(np.float32)
        self.tp = np.where(tpc == 255, NEG_INF, -tpc)
        # CI nodes accept any context
        self.lcmask = np.ones((nci, nci), bool)
        self.rcmask = np.ones((nci, nci), bool)

    def _build_tri(self):
        """PHMM net over unique (ci, ssid, tmat) with context bitmaps."""
        mdef = self.mdef
        nci = mdef.n_ciphone
        fillers = np.nonzero(mdef.phone_filler[:nci])[0]
        key2node: dict[tuple, int] = {}
        node_ci, node_ssid, node_tmat = [], [], []
        # CI phones first (mirrors the reference's pid order); their
        # bitmaps are all-set
        pid_ci = np.concatenate([np.arange(nci), mdef.phone_ci[nci:]])
        for pid in range(mdef.n_phone):
            k = (int(pid_ci[pid]), int(mdef.phone_ssid[pid]),
                 int(mdef.phone_tmat[pid]))
            if k not in key2node:
                key2node[k] = len(node_ci)
                node_ci.append(k[0])
                node_ssid.append(k[1])
                node_tmat.append(k[2])
        N = len(node_ci)
        self.n_node = N
        self.node_ci = np.asarray(node_ci, np.int32)
        lcmask = np.zeros((N, nci), bool)
        rcmask = np.zeros((N, nci), bool)
        lcmask[:nci] = True            # CI nodes connect to everything
        rcmask[:nci] = True
        for pid in range(nci, mdef.n_phone):
            n = key2node[(int(pid_ci[pid]), int(mdef.phone_ssid[pid]),
                          int(mdef.phone_tmat[pid]))]
            lc, rc = int(mdef.phone_lc[pid]), int(mdef.phone_rc[pid])
            # fillers map to every filler (phmm_build :289-306)
            if mdef.phone_filler[lc]:
                lcmask[n, fillers] = True
            else:
                lcmask[n, lc] = True
            if mdef.phone_filler[rc]:
                rcmask[n, fillers] = True
            else:
                rcmask[n, rc] = True
        self.lcmask = lcmask
        self.rcmask = rcmask
        self.senid = mdef.sseq[np.asarray(node_ssid)].astype(np.int32)
        tpc = self.am.tmat.tp[np.asarray(node_tmat)].astype(np.float32)
        self.tp = np.where(tpc == 255, NEG_INF, -tpc)

    def _device_tables(self, device) -> dict:
        t = host_to(device)
        nci = self.mdef.n_ciphone
        return dict(
            senid=t(self.senid.reshape(-1).astype(np.int64)),
            tp=t(self.tp), M=t(self.M),
            # source side: node -> its CI class, as scatter indices [N, c2]
            seg=t(np.broadcast_to(self.node_ci[:, None].astype(np.int64),
                                  (self.n_node, nci))),
            node_ci=t(self.node_ci.astype(np.int64)),
            lc_add=t(np.where(self.lcmask, 0.0, NEG_INF)
                     .astype(np.float32)),
            rc_add=t(np.where(self.rcmask, 0.0, NEG_INF)
                     .astype(np.float32)))

    def initial_carry(self):
        """(S, STF, PRC) [N, NST] at frame 0 on the device: any phone may
        start."""
        N, NST = self.n_node, self.mdef.n_emit_state
        S0 = np.full((N, NST), NEG_INF, np.float32)
        S0[:, 0] = 0.0
        t = host_to(self.device)
        return (t(S0), t(np.zeros((N, NST), np.int32)),
                t(np.full((N, NST), -1, np.int32)))

    def step(self, carry, sen_t, t):
        """One frame: carry (S, STF, PRC) [N, NST], sen_t [N, NST] senone
        goodness, t the frame index (an int, or a 0-d int32 tensor on the
        device).  Returns (new carry, records (out, out start frame, out
        predecessor class) [N])."""
        tb = self.tables
        S, STF, PRC = carry
        nci = self.mdef.n_ciphone
        newS, srcm, out, out_src = hmm_step(S, sen_t, tb["tp"])
        out_stf = out_meta(STF, out_src)
        out_prc = out_meta(PRC, out_src)
        newSTF = propagate_meta(STF, srcm)
        newPRC = propagate_meta(PRC, srcm)
        # factored node->node transition: the source side folds exits into
        # [c1, c2] (best exit of a ci-c1 node allowing rc c2)
        masked = out[:, None] + tb["rc_add"]                  # [N, c2]
        B = torch.full((nci, nci), -math.inf, dtype=torch.float32,
                       device=out.device).scatter_reduce(
            0, tb["seg"], masked, "amax")                     # [c1, c2]
        trans = torch.clamp(B, min=NEG_INF) + tb["M"]         # [c1, c2]
        # destination side: best incoming ci class per node (first max)
        cand = trans[:, tb["node_ci"]].T + tb["lc_add"]       # [N, c1]
        entry, ent_ci = torch.max(cand, dim=1)
        win = entry > newS[:, 0]
        newS[:, 0] = torch.where(win, entry, newS[:, 0])
        newSTF[:, 0] = torch.where(win, t + 1, newSTF[:, 0])
        newPRC[:, 0] = torch.where(win, ent_ci.to(torch.int32),
                                   newPRC[:, 0])
        m = newS.max()
        return (newS - m, newSTF, newPRC), (out, out_stf, out_prc)

    def decode(self, feats, costs=None):
        """Decode one utterance (feats [T, F, L], or its senone costs
        [T, n_sen]); returns (phone string, segs)."""
        costs = self.utterance_costs(feats, costs)
        T = costs.shape[0]
        N, NST = self.n_node, self.mdef.n_emit_state
        sen = -costs[:, self.tables["senid"]].reshape(T, N, NST)
        _, self.records = self._scan(self.step, self.initial_carry(),
                                     (sen,), T)
        return self._backtrace(*self.records, T)

    def _backtrace(self, eout, estf, eprc, T):
        """Host backtrace: follow (start frame, predecessor CI class)
        records; within a class the predecessor node is the argmax exit
        that allows the current node's CI as right context."""
        node_ci = self.node_ci
        rcmask = self.rcmask
        p = int(np.argmax(eout[T - 1]))
        segs = []
        t = T - 1
        while t >= 0 and p >= 0:
            s = int(estf[t, p])
            segs.append(Seg(word=self.mdef.ciname[node_ci[p]],
                            start=s, end=t))
            c1 = int(eprc[t, p])
            if s <= 0 or c1 < 0:
                break
            cand = np.where((node_ci == c1) & rcmask[:, node_ci[p]],
                            eout[s - 1], NEG_INF)
            p = int(np.argmax(cand))
            t = s - 1
        segs.reverse()
        return " ".join(s.word for s in segs), segs
