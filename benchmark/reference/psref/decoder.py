"""Decoder facade — the ps_decoder_t equivalent (src/pocketsphinx.c).

Port of `pocketsphinx_tpu.decoder`: one object owning config + acoustic
model + dictionary + searches, with the utterance API (start_utt /
process_raw / end_utt / hyp / seg) modeled on include/pocketsphinx.h, and
the Python API of the reference's Cython `Decoder`.

The split between host and device is the JAX package's: the frontend
and the CMN state run on the host in float64 (`MelFrontend.process`,
`compute_feats_typed`, and in streaming `FrontendStream` /
`FeatStream`, bit-identical to them); senone scoring, the fused n-gram
scan, the grammar / keyword / allphone / align steps and the lattice's
exit scan run on the decoder's device (CUDA unless `device="cpu"` is
passed); the backtraces, the keyword detection merge, the alignment
entries and the lattice passes after construction are host code.

Search modes: `lm` and `lmctl` (the fused n-gram search over one LM or
each LM of a set, 3- or 5-state models), `fsg` and `jsgf` (grammars),
`keyphrase` and `kws` (keyword spotting), `allphone`, and forced
alignment (`add_align_text`), with `update_mllr`.  As in the JAX
package, only the n-gram search streams; the others buffer the PCM and
decode at `end_utt`.  `PS_NGRAM_IMPL=flat` selects the dense flat search
(`search.ngram_flat`, the fused search's exactness oracle) for the LM
searches.  One extension: `decode_senscr` also aligns (the JAX decoder's
aligner scores features only).
"""

from __future__ import annotations

import math
import os
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from . import err, resolve_device
from .config import Config
from .fileio.dictionary import Dictionary
from .frontend.feat import CmnLive, compute_feats_typed
from .frontend.mfcc import MelFrontend
from .models.acoustic import AcousticModel, UNIT_NATS, senone_scores
from .models.dict2pid import Dict2Pid
from .profile import DecodeStats, PerfReport, Timer, log_xrt
from .search.align import Aligner
from .search.lattice import Lattice
from .search.ngram_fused import NgramFusedDecoder

@dataclass
class Hypothesis:
    hypstr: str
    score: int = 0
    prob: float = 1.0
    best_score: int = 0


@dataclass
class Segment:
    word: str
    start_frame: int
    end_frame: int
    ascore: float = 0.0
    lscore: float = 0.0
    prob: float = 1.0
    frate: int = 100

    @property
    def start(self) -> float:
        return self.start_frame / self.frate

    @property
    def duration(self) -> float:
        return (self.end_frame - self.start_frame + 1) / self.frate


class Decoder:
    """The reference's lifecycle API over the port's search, on
    `device` (CUDA unless `device="cpu"`; raises when CUDA is absent)."""

    def __init__(self, config: Config | None = None, device=None, **kwargs):
        if config is None:
            config = Config(**kwargs)
        elif kwargs:
            config.update(kwargs)
        self.config = config
        self.device = resolve_device(device)
        config.default_search_args()
        config.expand_model_config()
        mode = config.validate_search_mode()
        # logging subsystem wiring (err_set_logfile/err_set_loglevel,
        # src/pocketsphinx.c:256-271): honor -logfn and -loglevel
        if config["loglevel"]:
            err.set_loglevel(config["loglevel"])
        if config["logfn"]:
            err.set_logfile(config["logfn"])

        # The dense search evaluates every state every frame; the
        # reference's pruning knobs are accepted for config compatibility
        # but have no effect (the top-K word-exit shortlist is the only
        # prune, with a runtime exactness guard).
        _inert = ("beam", "wbeam", "pbeam", "lpbeam", "lponlybeam",
                  "fwdflatbeam", "fwdflatwbeam", "maxhmmpf", "maxwpf",
                  "pl_window", "pl_beam", "pl_pbeam", "pl_weight")
        _set = [p for p in _inert if config.is_user_set(p)]
        if _set:
            err.E_WARN(
                "parameters have no effect in the dense "
                "(unpruned) search and are ignored: "
                + " ".join("-" + p for p in _set))
        err.E_INFO(f"Initializing decoder: -hmm {config['hmm']} "
                   f"(search mode: {mode or 'none'}, device {self.device})")

        hmm = config["hmm"]
        if not hmm:
            raise ValueError("No acoustic model directory (-hmm) given")
        self.am = AcousticModel.load(
            hmm, varfloor=config["varfloor"], mixwfloor=config["mixwfloor"],
            tmatfloor=config["tmatfloor"],
            sendump=config["sendump"] if config.is_user_set("sendump")
            else None)
        self.fe = MelFrontend.from_config(config)
        self.dict = Dictionary(self.am.mdef, config["dict"],
                               config["fdict"],
                               dictcase=config["dictcase"])
        self.d2p = Dict2Pid(self.am.mdef, self.dict)
        self.cmn_state = CmnLive(config["ceplen"])
        if config["cmninit"]:
            try:
                self.cmn_state.set_repr(config["cmninit"])
            except ValueError:
                pass

        self._searches: dict[str, object] = {}
        self._active: str | None = None
        self._raw = []
        self._hyp: Hypothesis | None = None
        self._segs: list[Segment] = []
        self._costs = None
        self._feats = None

        # xRT timing + work counters (ps->perf / ngram_search_stats_t;
        # see profile.py); stage timers wait for the device's work
        self.perf = Timer("decode", self.device)
        self.stage_timers = {k: Timer(k, self.device) for k in
                             ("frontend", "search", "bestpath")}
        self.all_perf = PerfReport()
        self.stats = DecodeStats()

        if mode == "lm":
            self.add_lm("_default", config["lm"])
            self.activate_search("_default")
        elif mode == "fsg":
            from .lm.fsg import FsgModel
            self.add_fsg("_default", FsgModel.readfile(
                config["fsg"], lw=config["lw"]))
            self.activate_search("_default")
        elif mode == "jsgf":
            self.add_jsgf("_default", config["jsgf"], config["toprule"])
            self.activate_search("_default")
        elif mode == "keyphrase":
            self.add_keyphrase("_default", config["keyphrase"])
            self.activate_search("_default")
        elif mode == "kws":
            self.add_kws("_default", config["kws"])
            self.activate_search("_default")
        elif mode == "allphone":
            self.add_allphone("_default", config["allphone"])
            self.activate_search("_default")
        elif mode == "lmctl":
            from .lm.lmset import NgramModelSet
            self.lmset = NgramModelSet.read_lmctl(
                config["lmctl"], lw=config["lw"], wip=config["wip"])
            for name in self.lmset.models:
                self.add_lm(name, self.lmset.models[name])
            self.activate_search(config["lmname"] or self.lmset.active)

    def _to(self, device, graph=None) -> "Decoder":
        """A read-only twin for checking one device's run against
        another's: its searches' tables on `device` and a copy of the CMN
        state, but a shallow copy otherwise, so it shares this decoder's
        config, dictionary, model and LMs; `graph=False` steps every
        search's frames eagerly (each search's `to`).  Do not change
        either one (`add_word`, `load_dict`, `update_mllr`, ...): the
        other's searches would not be rebuilt."""
        import copy
        other = object.__new__(type(self))
        other.__dict__.update(self.__dict__)
        other.device = torch.device(device)
        other._searches = {k: s.to(other.device, graph=graph)
                           for k, s in self._searches.items()}
        other.cmn_state = copy.deepcopy(self.cmn_state)
        other.perf = Timer("decode", other.device)
        other.stage_timers = {k: Timer(k, other.device)
                              for k in self.stage_timers}
        other.all_perf, other.stats = PerfReport(), DecodeStats()
        other._fe_stream_active = False
        other._lattice = None
        other.start_utt()
        return other

    # -- search management (include/pocketsphinx/search.h) -------------------

    def add_lm(self, name: str, lm_or_path):
        from .lm.ngram import read_lm
        lm = lm_or_path
        if isinstance(lm_or_path, str):
            lm = read_lm(lm_or_path, lw=self.config["lw"],
                         wip=self.config["wip"])
        Impl = NgramFusedDecoder
        if os.environ.get("PS_NGRAM_IMPL", "fused") == "flat":
            from .search.ngram_flat import NgramFlatDecoder as Impl
        self._searches[name] = Impl(
            self.am, self.d2p, lm,
            silprob=self.config["silprob"],
            fillprob=self.config["fillprob"],
            pip=self.config["pip"], nwpen=self.config["nwpen"],
            device=self.device)
        return self._searches[name]

    def add_fsg(self, name: str, fsg):
        """A grammar search over `fsg` (an `lm.fsg.FsgModel`, which gains
        the filler self-loops and alternate pronunciations)."""
        from .search.fsg import FsgDecoder
        self._searches[name] = FsgDecoder(
            self.am, self.d2p, fsg,
            wip=self.config["wip"], pip=self.config["pip"],
            silprob=self.config["silprob"],
            fillprob=self.config["fillprob"],
            use_filler=self.config["fsgusefiller"],
            use_altpron=self.config["fsgusealtpron"], device=self.device)
        return self._searches[name]

    def add_jsgf(self, name: str, path: str, toprule: str | None = None):
        from .lm.jsgf import Jsgf
        fsg = Jsgf.parse_file(path).build_fsg(toprule,
                                              lw=self.config["lw"])
        return self.add_fsg(name, fsg)

    def add_jsgf_string(self, name: str, text: str,
                        toprule: str | None = None):
        from .lm.jsgf import Jsgf
        fsg = Jsgf(text).build_fsg(toprule, lw=self.config["lw"])
        return self.add_fsg(name, fsg)

    def add_keyphrase(self, name: str, keyphrase: str):
        from .search.kws import KwsDecoder
        self._searches[name] = KwsDecoder(
            self.am, self.d2p, [(keyphrase, self.config["kws_threshold"])],
            plp=self.config["kws_plp"], delay=self.config["kws_delay"],
            device=self.device)
        return self._searches[name]

    def add_kws(self, name: str, path: str):
        from .search.kws import KwsDecoder, parse_kws_file
        self._searches[name] = KwsDecoder(
            self.am, self.d2p,
            parse_kws_file(path, self.config["kws_threshold"]),
            plp=self.config["kws_plp"], delay=self.config["kws_delay"],
            device=self.device)
        return self._searches[name]

    def add_allphone(self, name: str, lm_path: str | None):
        from .lm.ngram import read_lm
        from .search.allphone import AllphoneDecoder
        lm = read_lm(lm_path, lw=self.config["lw"],
                     wip=self.config["wip"]) if lm_path else None
        self._searches[name] = AllphoneDecoder(
            self.am, lm, ci_only=self.config["allphone_ci"],
            device=self.device)
        return self._searches[name]

    def add_align_text(self, text: str, name: str = "_align"):
        """A forced-alignment search over the words of `text`, made the
        active search."""
        words = text.split()
        for w in words:
            if self.dict.wordid(w) < 0:
                raise KeyError(f"Unknown word {w!r}")
        al = Aligner(self.am, self.d2p,
                     silprob=self.config["silprob"],
                     wip=self.config["wip"], lw=self.config["lw"],
                     device=self.device)
        al._align_words = words
        self._searches[name] = al
        self.activate_search(name)
        return al

    def activate_search(self, name: str):
        if name not in self._searches:
            raise KeyError(f"No search named {name!r}")
        self._active = name

    def current_search_name(self) -> str | None:
        return self._active

    def remove_search(self, name: str):
        del self._searches[name]
        if self._active == name:
            self._active = None

    # -- word management -----------------------------------------------------

    def add_word(self, word: str, phones: str, update: bool = True):
        """ps_add_word: register a pronunciation (phones as a string of
        CI phone names)."""
        pids = []
        for ph in phones.split():
            p = self.am.mdef.ciphone_id(ph, nocase=self.dict.dictcase)
            if p < 0:
                raise KeyError(f"Unknown phone {ph!r}")
            pids.append(p)
        wid = self.dict.add_word(word, pids)
        # n-gram searches also get the word as a fresh unigram so it can
        # actually be recognized (ps_add_word src/pocketsphinx.c:940 ->
        # ngram_model_add_word(lmset, word, 1.0))
        for s in self._searches.values():
            lm = getattr(s, "lm", None)
            if lm is not None and hasattr(lm, "add_word") \
                    and lm.wid(word) < 0:
                lm.add_word(word, 1.0)
        if update:
            # rebuild the searches that embed the dictionary
            for s in self._searches.values():
                s.rebuild()
        return wid

    def load_dict(self, dictfile: str, fdict: str | None = None,
                  fmt: str | None = None) -> int:
        """ps_load_dict: replace the pronunciation dictionary mid-life and
        rebuild every search.  Returns 0 on success, -1 on failure
        (missing file), leaving the decoder unchanged on failure."""
        try:
            d = Dictionary(self.am.mdef, dictfile,
                           fdict or self.config["fdict"],
                           dictcase=self.config["dictcase"])
        except (FileNotFoundError, OSError, ValueError):
            return -1
        self.dict = d
        self.d2p = Dict2Pid(self.am.mdef, d)
        for s in self._searches.values():
            if hasattr(s, "d2p"):           # not the allphone search
                s.d2p = self.d2p
                s.dict = d
            s.rebuild()
        return 0

    def lookup_word(self, word: str) -> str | None:
        wid = self.dict.wordid(word)
        if wid < 0:
            return None
        return " ".join(self.am.mdef.ciname[p] for p in self.dict.pron(wid))

    def update_mllr(self, mllr_or_path):
        """ps_update_mllr: apply an MLLR transform to the loaded
        Gaussians and refresh the scoring tables (host arrays and the
        cached device tensors).

        Like the reference (gauden_mllr_transform, src/ms_gauden.c:512,
        which re-reads the means before transforming), each call applies
        to the pristine model, not cumulatively: the original parameters
        are kept on first use and restored before every transform.  None
        just restores the original model."""
        from .models.mllr import Mllr
        g = self.am.gauden
        if not hasattr(g, "_pristine"):
            g._pristine = (g.means.copy(), g.var.copy())
        else:
            g.means[...] = g._pristine[0]
            g.var[...] = g._pristine[1]
        mllr = mllr_or_path
        if mllr_or_path is None:
            from .logmath import default_logmath
            g.precompute(default_logmath(), self.config["varfloor"])
        else:
            if isinstance(mllr_or_path, str):
                mllr = Mllr.read(mllr_or_path)
            mllr.transform(g, varfloor=self.config["varfloor"])
        for key in ("scoring_arrays", "_scoring_tensors"):
            self.am.__dict__.pop(key, None)
        return mllr

    # -- CMN state (ps_get_cmn / ps_set_cmn) ---------------------------------

    def get_cmn(self) -> str:
        return self.cmn_state.repr_string()

    def set_cmn(self, repr_str: str):
        self.cmn_state.set_repr(repr_str)

    # -- utterance API -------------------------------------------------------

    def start_utt(self):
        self._raw = []
        self._hyp = None
        self._segs = []
        self._costs = None
        self._feats = None

    STREAM_BLOCK = 32   # frames per incremental search step

    def process_raw(self, data, no_search: bool = False,
                    full_utt: bool = False):
        """Feed PCM.  With full_utt=False (streaming), the frontend,
        scoring and search advance incrementally and partial_hyp()
        returns results mid-utterance (the reference's live mode)."""
        pcm = np.frombuffer(data, dtype="<i2") if isinstance(
            data, (bytes, bytearray)) else np.asarray(data, dtype=np.int16)
        self._raw.append(pcm)
        if not full_utt and not no_search and self._stream_capable():
            self._ensure_stream()
            cep = self._fe_stream.process(pcm)
            feats = self._feat_stream.process(cep)
            self._stream_feats(feats)
        return len(pcm)

    # -- streaming (incremental) decode -------------------------------------

    def _stream_capable(self) -> bool:
        """Only the n-gram searches stream (their `with_carry`); the others
        decode the buffered PCM at `end_utt`."""
        return (self._active is not None
                and hasattr(self._searches[self._active], "with_carry")
                and self.config["feat"] == "1s_c_d_dd"
                and (self.config["svspec"] or "") == "0-12/13-25/26-38")

    def _ensure_stream(self):
        if getattr(self, "_fe_stream_active", False):
            return
        from .frontend.stream import FrontendStream, FeatStream
        self._fe_stream = FrontendStream(self.fe)
        self._feat_stream = FeatStream(
            feat_type=self.config["feat"],
            svspec=self.config["svspec"], cmn=self.config["cmn"],
            cmn_state=self.cmn_state)
        self._stream_carry = None            # the search's init_carry
        self._stream_recs = []
        self._stream_t = 0
        self._stream_pending = np.zeros((0, 3, 13), np.float32)
        #: seconds of each streamed block (scoring + scan + records to
        #: the host), the latency a live user waits per block
        self.stream_block_seconds = []
        self._fe_stream_active = True

    def _stream_feats(self, feats, flush: bool = False):
        if len(feats):
            self._stream_pending = np.concatenate(
                [self._stream_pending, np.asarray(feats, np.float32)])
        B = self.STREAM_BLOCK
        search = self._searches[self._active]
        while len(self._stream_pending) >= B or (
                flush and len(self._stream_pending)):
            t0 = self._sync()
            block = self._stream_pending[:B]
            self._stream_pending = self._stream_pending[B:]
            n = len(block)
            if n < B:
                block = np.concatenate(
                    [block, np.zeros((B - n,) + block.shape[1:],
                                     np.float32)])
            costs = self._scores(block)[None]
            valid = torch.as_tensor(np.arange(B) < n,
                                    device=self.device)[None]
            # padded block tails are masked out of the carry
            recs, self._stream_carry = search.with_carry(
                costs, valid, self._stream_carry, self._stream_t)
            self._stream_recs.append(
                tuple(r[0, :n].cpu().numpy() for r in recs))
            self._stream_t += n
            self.stream_block_seconds.append(self._sync() - t0)

    def _sync(self):
        """The wall clock once the device's queued work is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _stream_records(self, search):
        recs = tuple(np.concatenate([r[i] for r in self._stream_recs])
                     for i in range(len(self._stream_recs[0])))
        return search.adapt_records(recs, self._stream_t)

    def _finish_stream(self):
        cep = self._fe_stream.process(np.zeros(0, np.int16), end=True)
        feats = self._feat_stream.process(cep, end=True)
        self._stream_feats(feats, flush=True)
        search = self._searches[self._active]
        if self._stream_recs:
            search.records = self._stream_records(search)
            self._feats = np.zeros((self._stream_t, 3, 13), np.float32)
            hyp, segs = search._backtrace(search.records, self._stream_t)
            self._segs = [Segment(s.word, s.start, s.end,
                                  frate=self.fe.frate) for s in segs]
            self._hyp = Hypothesis(hypstr=hyp)
            self._lattice = None
            if self.config["bestpath"]:
                self._run_bestpath(search)
        self._fe_stream_active = False

    def partial_hyp(self):
        """Best hypothesis so far, mid-utterance (streaming mode)."""
        if not getattr(self, "_fe_stream_active", False) \
                or not self._stream_recs:
            return self._hyp
        search = self._searches[self._active]
        hyp, _ = search._backtrace(self._stream_records(search),
                                   self._stream_t)
        return Hypothesis(hypstr=hyp)

    def end_utt(self):
        if getattr(self, "_fe_stream_active", False):
            self._finish_stream()
            return
        if not self._raw:
            return
        self.perf.reset()
        for t in self.stage_timers.values():
            t.reset()
        self.perf.start()
        pcm = np.concatenate(self._raw)
        with self.stage_timers["frontend"]:
            cep = self.fe.process(pcm)
            lda = None
            if self.config["lda"]:
                from .fileio import read_lda
                if not hasattr(self, "_lda"):
                    self._lda = read_lda(self.config["lda"])
                lda = self._lda
            feats, featlen = compute_feats_typed(
                cep, feat_type=self.config["feat"],
                svspec=self.config["svspec"],
                cmn=self.config["cmn"], cmn_state=self.cmn_state,
                agc=self.config["agc"], varnorm=self.config["varnorm"],
                lda=lda, ldadim=self.config["ldadim"])
        self._feats = feats
        self._write_logs(pcm, cep)
        self._decode(feats)
        self.perf.stop()
        self._account_utt(len(feats))

    def _scores(self, feats, **kw):
        """Senone costs [T, n_sen] of host feats [T, F, L] on the
        decoder's device."""
        x = torch.as_tensor(np.asarray(feats, np.float32)[None],
                            device=self.device)
        return senone_scores(self.am.scoring_tensors(self.device), x,
                             **kw)[0]

    def _write_logs(self, pcm, cep):
        """Per-utterance trace seams: -rawlogdir/-mfclogdir/-senlogdir
        (src/pocketsphinx.c:1124-1163, acmod dump formats)."""
        uttid = f"{getattr(self, '_uttno', 0):09d}"
        self._uttno = getattr(self, "_uttno", 0) + 1
        if self.config["rawlogdir"]:
            with open(os.path.join(self.config["rawlogdir"],
                                   uttid + ".raw"), "wb") as f:
                f.write(np.asarray(pcm, dtype="<i2").tobytes())
        if self.config["mfclogdir"]:
            from .fileio.mfc import write_mfc
            write_mfc(os.path.join(self.config["mfclogdir"],
                                   uttid + ".mfc"), cep)
        if self.config["senlogdir"]:
            from .fileio.mfc import write_sen
            write_sen(os.path.join(self.config["senlogdir"],
                                   uttid + ".sen"),
                      self._scores(self._feats).cpu().numpy(),
                      mdef_file=self.config["mdef"] or "none")

    def set_rawdata_size(self, size: int):
        """Retain up to `size` samples of utterance PCM for
        get_rawdata() (the historic Python Decoder's seam)."""
        self._rawdata_size = max(int(size), 0)

    def get_rawdata(self):
        """The current/last utterance's raw PCM (int16), truncated to
        the newest set_rawdata_size samples if one was set."""
        if not self._raw:
            return np.zeros(0, np.int16)
        pcm = np.concatenate(self._raw)
        n = getattr(self, "_rawdata_size", 0)
        return pcm[-n:] if n else pcm

    def decode_raw(self, data) -> Hypothesis | None:
        self.start_utt()
        self.process_raw(data, full_utt=True)
        self.end_utt()
        return self._hyp

    def decode_senscr(self, costs: np.ndarray):
        """Decode directly from a senone-score matrix [T, n_sen]
        (the ps_decode_senscr test seam)."""
        self.start_utt()
        self._costs = np.asarray(costs, dtype=np.float32)
        self._decode(None, costs=self._costs)

    def _decode(self, feats, costs=None):
        if self._active is None:
            raise RuntimeError("No search module is selected, did you "
                               "forget to specify a language model or "
                               "grammar?")
        search = self._searches[self._active]
        if isinstance(search, Aligner):
            with self.stage_timers["search"]:
                words, phones, states = search.align(
                    feats, search._align_words, costs=costs)
            self._segs = [Segment(w.text, w.start, w.start + w.duration - 1,
                                  ascore=w.score, frate=self.fe.frate)
                          for w in words]
            self._align_result = (words, phones, states)
            text = " ".join(w.text for w in words if w.text != "<sil>")
            self._hyp = Hypothesis(hypstr=text)
            return
        with self.stage_timers["search"]:
            if costs is None and self.config["ds"] > 1:
                # honor -ds (frame GMM downsampling, src/ptm_mgau.c:241-243)
                # by scoring here and passing costs through the search seam
                costs = self._scores(feats, ds=self.config["ds"])
            hyp, segs = search.decode(feats, costs=costs)
        self._segs = [Segment(s.word, s.start, s.end,
                              frate=self.fe.frate) for s in segs]
        # first-pass path score from the backtrace, in logmath units (the
        # reference fills it in bp_hyp, src/ngram_search.c:545; prob stays
        # 1.0 until bestpath posteriors run); 0 for searches without one
        sc = getattr(search, "hyp_score", None)
        sc_i = int(round(sc * (1 << 10))) if sc is not None else 0
        self._hyp = Hypothesis(hypstr=hyp, score=sc_i, best_score=sc_i)
        self._lattice = None
        # the n-gram and grammar searches keep word-exit records
        if self.config["bestpath"] and hasattr(search, "lattice_inputs"):
            with self.stage_timers["bestpath"]:
                self._run_bestpath(search)

    def _run_bestpath(self, search):
        """Third pass: lattice + best-path rescoring + posteriors
        (ngram_search_hyp -> ps_lattice_bestpath/posterior)."""
        try:
            lat = Lattice.from_flat_records(search)
        except Exception as e:
            # A lattice-layer failure must not silently downgrade every
            # result to the first-pass hyp: warn loudly, and re-raise
            # under the debug flag so tests / developers see the error.
            if os.environ.get("PS_DEBUG") or \
                    self.config["loglevel"] == "DEBUG":
                raise
            warnings.warn(
                f"bestpath lattice construction failed ({e!r}); "
                f"falling back to the first-pass hypothesis. Set "
                f"PS_DEBUG=1 (or -loglevel DEBUG) to re-raise.",
                RuntimeWarning, stacklevel=2)
            return
        lm = getattr(search, "lm", None)          # None for a grammar
        lwf = (self.config["bestpathlw"] / self.config["lw"]
               if self.config["lw"] else 1.0)
        silpen = math.log(self.config["silprob"]) / UNIT_NATS
        fillpen = math.log(self.config["fillprob"]) / UNIT_NATS
        finish = None
        if getattr(search, "finish_idx", None) is not None:
            finish = self.dict.wordstr(search.words[search.finish_idx])
        hyp, segs, score = lat.bestpath(lm=lm, lwf=lwf, silpen=silpen,
                                        fillpen=fillpen,
                                        finish_word=finish,
                                        ascale=self.config["ascale"])
        if not hyp and not segs:
            return
        post = lat.posterior(lm=lm, ascale=self.config["ascale"])
        self._lattice = lat
        # lattice scores are in shifted units; the public Hypothesis
        # carries logmath units like the first-pass score (x 1<<10, the
        # scaling the segment ascores use below)
        self._hyp = Hypothesis(hypstr=hyp, score=int(score) * (1 << 10),
                               best_score=int(score) * (1 << 10),
                               prob=math.exp(min(post, 0.0)))
        scr = getattr(lat, "_best_seg_scores", None) or [(0, 0)] * len(segs)
        self._segs = [
            Segment(w, s, e, frate=self.fe.frate,
                    prob=lat.node_posterior(w, s),
                    ascore=a * (1 << 10), lscore=ls * (1 << 10))
            for (w, s, e), (a, ls) in zip(segs, scr)]

    def _account_utt(self, n_frames: int):
        """Accumulate totals + counters and log xRT at INFO level
        (src/ngram_search.c:866-871-style lines)."""
        n_speech = n_frames / self.fe.frate
        self._utt_speech = n_speech
        self.all_perf.add(n_speech, self.perf,
                          self.stage_timers.values())
        search = self._searches.get(self._active)
        self.stats.add_utt(
            n_frames, getattr(search, "P", 0),
            self.am.scoring_arrays["w_lin"].shape[-1],
            getattr(search, "W", 0))
        if self.config["loglevel"] in ("INFO", "DEBUG"):
            for t in self.stage_timers.values():
                log_xrt(t.name, t, n_speech,
                        loglevel=self.config["loglevel"])
            log_xrt("decode", self.perf, n_speech,
                    loglevel=self.config["loglevel"])

    def get_utt_time(self):
        """(n_speech, n_cpu, n_wall) for the last utterance
        (ps_get_utt_time, include/pocketsphinx.h:1079)."""
        return (getattr(self, "_utt_speech", 0.0),
                self.perf.t_cpu, self.perf.t_elapsed)

    def get_all_time(self):
        """(n_speech, n_cpu, n_wall) accumulated over all utterances
        (ps_get_all_time, include/pocketsphinx.h:1093)."""
        p = self.all_perf
        return (p.n_speech, p.t_cpu, p.t_elapsed)

    def get_lattice(self):
        return getattr(self, "_lattice", None)

    def read_lattice(self, path: str):
        """ps_lattice_read: load a Sphinx-III DAG file (e.g. one written
        by Lattice.write or by the reference) as the current lattice."""
        lat = Lattice.read(path, dictionary=self.dict, frate=self.fe.frate)
        self._lattice = lat
        return lat

    def nbest(self, n: int = 10):
        """ps_nbest: A* N-best hypotheses over the word lattice."""
        lat = self.get_lattice()
        if lat is None and self._active:
            search = self._searches[self._active]
            if getattr(search, "_records", None) is not None:
                lat = Lattice.from_flat_records(search)
                self._lattice = lat
        if lat is None:
            return []
        return lat.nbest(n, lm=getattr(self._searches[self._active], "lm",
                                       None))

    # -- results -------------------------------------------------------------

    def hyp(self) -> Hypothesis | None:
        return self._hyp

    def seg_iter(self):
        return iter(self._segs)

    def get_alignment(self):
        """(word, phone, state) `AlignEntry` lists of the last aligned
        utterance, or None."""
        return getattr(self, "_align_result", None)

    @property
    def n_frames(self) -> int:
        return 0 if self._feats is None else len(self._feats)
