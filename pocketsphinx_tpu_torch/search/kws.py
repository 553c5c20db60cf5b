"""Keyword spotting: keyphrase HMM chains vs. a CI phone-loop background
(src/kws_search.c re-design).

Port of `pocketsphinx_tpu.search.kws`.  `parse_kws_file`, the network
build (`_build`) and the detection merge with its `delay` filter are
host code, copied; the per-frame step is torch on the search's device
(CUDA unless `device="cpu"`), and its records (the per-keyphrase ratio
and start frame) are copied to the host once per utterance.

Each keyphrase is a linear phone chain; the background model is a loop
over all CI phones with loop probability kws_plp.  A detection fires when
the keyphrase's exit likelihood beats the background path over the same
span by the per-keyphrase threshold (p(keyphrase)/p(background) ratio,
src/kws_search.c:620-700), evaluated densely every frame.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..models.acoustic import AcousticModel, UNIT_NATS
from ..models.dict2pid import Dict2Pid
from ..ops.hmm import hmm_step, out_meta, propagate_meta
from .base import DeviceSearch, host_to
from .ngram_fused import Seg

NEG_INF = -1e30
#: kws_search.c:59: detection probability = ratio - KWS_MAX
KWS_MAX = 1500.0


def parse_kws_file(path: str, default_threshold: float):
    """Parse a -kws file: one keyphrase per line, optional /threshold/
    suffix; malformed lines are skipped with a warning like the
    reference (kws_search.c keyphrase file parsing)."""
    out = []
    for line in open(path):
        line = line.strip()
        if not line:
            continue
        if "/" in line:
            parts = line.split("/")
            try:
                thresh = float(parts[1])
            except (ValueError, IndexError):
                sys.stderr.write(f"WARNING: bad kws line {line!r}\n")
                continue
            out.append((parts[0].strip(), thresh))
        else:
            out.append((line, default_threshold))
    return out


@dataclass
class Detection:
    keyphrase: str
    start: int
    end: int
    score: float


class KwsDecoder(DeviceSearch):
    def __init__(self, am: AcousticModel, d2p: Dict2Pid,
                 keyphrases: list[tuple[str, float]],
                 plp: float = 0.1, delay: int = 10, device=None):
        self.device = resolve_device(device)
        self.am = am
        self.d2p = d2p
        self.dict = d2p.dict
        self.mdef = am.mdef
        self.delay = delay
        self.log_plp = math.log(plp) / UNIT_NATS
        self.keyphrases = keyphrases
        self.rebuild()

    def _build(self):
        mdef, d, d2p = self.mdef, self.dict, self.d2p
        sil = mdef.sil
        # background: all CI phones
        nci = mdef.n_ciphone
        self.bg_senid = mdef.sseq[mdef.phone_ssid[:nci]].astype(np.int32)
        tpc = self.am.tmat.tp[mdef.phone_tmat[:nci]].astype(np.float32)
        self.bg_tp = np.where(tpc == 255, NEG_INF, -tpc)
        # keyphrases: per-word triphone chains with SIL outer contexts,
        # exactly like kws_search_reinit (src/kws_search.c:80-107):
        # first phone ldiph_lc(ci, next, SIL), last phone rssid with
        # SIL right context, word-internal triphones in between
        self.kw_units = []      # [(ci, ssid)] per keyphrase
        usable = []
        for phrase, thresh in self.keyphrases:
            units = []
            ok = True
            for w in phrase.split():
                wid = d.wordid(w)
                if wid < 0:
                    sys.stderr.write(
                        f"WARNING: unknown word {w!r}; skipping "
                        f"keyphrase {phrase!r}\n")
                    ok = False
                    break
                pron = [int(p) for p in d.pron(wid)]
                L = len(pron)
                for p, ci in enumerate(pron):
                    if p == 0:
                        rc = pron[1] if L > 1 else sil
                        ssid = int(d2p.ldiph_lc[ci, rc, sil])
                    elif p == L - 1:
                        uniq, cimap = d2p.rssid(ci, pron[p - 1])
                        ssid = int(uniq[int(cimap[sil])])
                    else:
                        ssid = int(d2p.internal_ssids(wid)[p - 1])
                    units.append((ci, ssid))
            if ok and units:
                usable.append((phrase, thresh))
                self.kw_units.append(units)
        if not usable:
            raise ValueError("no usable keyphrases")
        self.keyphrases = usable
        self.thresholds = [math.log(t) / UNIT_NATS
                           for _, t in usable]
        K = max(len(u) for u in self.kw_units)
        NK = len(self.kw_units)
        self.kw_len = np.array([len(u) for u in self.kw_units])
        nst = mdef.n_emit_state
        senid = np.zeros((NK, K, nst), np.int32)
        tp = np.full((NK, K, nst, nst + 1), NEG_INF, np.float32)
        for i, units in enumerate(self.kw_units):
            for j, (ci, ssid) in enumerate(units):
                senid[i, j] = mdef.sseq[ssid]
                t = self.am.tmat.tp[mdef.phone_tmat[ci]].astype(np.float32)
                tp[i, j] = np.where(t == 255, NEG_INF, -t)
        self.kw_senid = senid
        self.kw_tp = tp

    def _device_tables(self, device) -> dict:
        t = host_to(device)
        return dict(
            senid=t(np.concatenate([self.bg_senid.reshape(-1),
                                    self.kw_senid.reshape(-1)])
                    .astype(np.int64)),
            bg_tp=t(self.bg_tp), kw_tp=t(self.kw_tp),
            last=t((self.kw_len - 1).astype(np.int64)),
            kw=t(np.arange(len(self.kw_len), dtype=np.int64)))

    def decode(self, feats, costs=None):
        """Returns (hyp string of detections, segs)."""
        dets = self.detect(feats, costs)
        segs = [Seg(word=d.keyphrase, start=d.start, end=d.end)
                for d in dets]
        return " ".join(d.keyphrase for d in dets), segs

    def initial_carry(self):
        """(Sbg [nci, NST], Skw, STF [NK, K, NST]) at frame 0 on the
        device: the phone loop entered everywhere, keyphrases dead."""
        nci = self.bg_senid.shape[0]
        NK, K, NST = self.kw_senid.shape
        Sbg0 = np.full((nci, NST), NEG_INF, np.float32)
        Sbg0[:, 0] = 0.0
        t = host_to(self.device)
        return (t(Sbg0), t(np.full((NK, K, NST), NEG_INF, np.float32)),
                t(np.zeros((NK, K, NST), np.int32)))

    def step(self, carry, bg_sen, kw_sen, t):
        """One frame: carry (Sbg, Skw, STF), the background's and the
        keyphrases' senone goodness, t the frame index.  Returns (new
        carry, records (ratio, start frame) [NK])."""
        tb = self.tables
        Sbg, Skw, STF = carry
        plp = float(np.float32(self.log_plp))
        Sbg, _, bg_out, _ = hmm_step(Sbg, bg_sen, tb["bg_tp"])
        bg_best = bg_out.max()
        # keyphrase chains
        Skw, kwsrc, kw_out, kw_osrc = hmm_step(Skw, kw_sen, tb["kw_tp"])
        # the detection fires BEFORE transitions, from this frame's exit
        # scores (kws_search_trans order, src/kws_search.c:262-295): last
        # hmm exit vs best phone-loop exit, sf = the token's entry frame
        # (read, as in the JAX search, from the propagated start frames)
        STF = propagate_meta(STF, kwsrc)
        kw, last = tb["kw"], tb["last"]
        kw_exit = kw_out[kw, last]
        exit_stf = out_meta(STF, kw_osrc)
        kw_stf = exit_stf[kw, last]
        valid = (kw_exit > NEG_INF / 2) & (bg_best > NEG_INF / 2)
        ratio = torch.where(valid, kw_exit - bg_best, NEG_INF)
        # background loop: re-enter all phones from the best exit with the
        # loop probability
        enter = bg_best + plp
        Sbg[:, 0] = torch.maximum(Sbg[:, 0], enter)
        # chain transitions j-1 -> j (hmm_out(pred) vs hmm_in(next))
        ent = torch.nn.functional.pad(kw_out[:, :-1], (1, 0),
                                      value=NEG_INF)
        ent_stf = torch.nn.functional.pad(exit_stf[:, :-1], (1, 0))
        win = ent > Skw[:, :, 0]
        Skw[:, :, 0] = torch.where(win, ent, Skw[:, :, 0])
        STF[:, :, 0] = torch.where(win, ent_stf, STF[:, :, 0])
        # keyphrase start: enter the first phone from the best phone-loop
        # exit with NO loop penalty, sf = current frame
        # (src/kws_search.c:318-322)
        st_win = bg_best > Skw[:, 0, 0]
        Skw[:, 0, 0] = torch.where(st_win, bg_best, Skw[:, 0, 0])
        STF[:, 0, 0] = torch.where(st_win, t, STF[:, 0, 0])
        # renormalize
        m = torch.maximum(Sbg.max(), Skw.max())
        return (Sbg - m, Skw - m, STF), (ratio, kw_stf)

    def detect(self, feats, costs=None) -> list[Detection]:
        costs = self.utterance_costs(feats, costs)
        T = costs.shape[0]
        nci = self.bg_senid.shape[0]
        NK, K, NST = self.kw_senid.shape
        sen = -costs[:, self.tables["senid"]]
        bg_sen_all = sen[:, :nci * NST].reshape(T, nci, NST)
        kw_sen_all = sen[:, nci * NST:].reshape(T, NK, K, NST)
        _, self.records = self._run(self.step, self.initial_carry(),
                                    (bg_sen_all, kw_sen_all), T)
        return self._detections(*self.records, T)

    def _detections(self, ratios, stfs, T) -> list[Detection]:
        """The exact kws_detections_add merge (src/kws_detections.c:52-80:
        an overlapping same-keyphrase detection is replaced when the new
        probability is better) with prob = ratio - KWS_MAX
        (src/kws_search.c:59,290), then the kws_delay hyp filter
        (detections still within `delay` frames of the end are withheld,
        kws_detections_hyp_str)."""
        dets: list[Detection] = []
        for t in range(T):
            for i, (phrase, _) in enumerate(self.keyphrases):
                if ratios[t, i] < self.thresholds[i] \
                        or ratios[t, i] <= NEG_INF / 2:
                    continue
                sf, ef = int(stfs[t, i]), t
                prob = float(ratios[t, i]) - KWS_MAX
                for d_ in dets:
                    if d_.keyphrase == phrase and d_.start < ef \
                            and d_.end > sf:
                        if d_.score < prob:
                            d_.start, d_.end, d_.score = sf, ef, prob
                        break
                else:
                    dets.append(Detection(keyphrase=phrase, start=sf,
                                          end=ef, score=prob))
        dets = [d_ for d_ in dets if d_.end <= T - self.delay]
        dets.sort(key=lambda d_: d_.start)
        return dets
