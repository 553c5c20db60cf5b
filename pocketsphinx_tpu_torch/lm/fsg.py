"""Finite-state grammar model (src/lm/fsg_model.c re-design).

Port of `pocketsphinx_tpu.lm.fsg`: host NumPy code, copied.

Word-level FSG: states, weighted word transitions, epsilon (null)
transitions with best-path closure, silence/filler self-loops and
alternate-pronunciation expansion hooks.  Log probabilities are stored in
*unshifted* float logmath units scaled by the language weight, matching
fsg_model_trans_add / fsg_model_add_silence (src/lm/fsg_model.c:100-170,
395-420).

Text format (fsg_model_readfile, src/lm/fsg_model.c:517-700):
    FSG_BEGIN [name]
    NUM_STATES <n> / N <n>
    START_STATE <s> / S <s>
    FINAL_STATE <s> / F <s>
    TRANSITION <from> <to> <prob> [word] / T ...
    FSG_END
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

LN_BASE = math.log(1.0001)


@dataclass
class FsgLink:
    src: int
    dst: int
    logprob: float      # log base 1.0001 x lw (unshifted units)
    wid: int            # index into FsgModel.vocab, -1 for epsilon


@dataclass
class FsgModel:
    name: str
    n_state: int
    start_state: int
    final_state: int
    lw: float = 1.0
    vocab: list[str] = field(default_factory=list)
    links: list[FsgLink] = field(default_factory=list)
    _widx: dict = field(default_factory=dict)

    def word_add(self, word: str) -> int:
        if word in self._widx:
            return self._widx[word]
        self.vocab.append(word)
        self._widx[word] = len(self.vocab) - 1
        return len(self.vocab) - 1

    def word_id(self, word: str) -> int:
        return self._widx.get(word, -1)

    def trans_add(self, src: int, dst: int, logprob: float, wid: int):
        """logprob in logmath units x lw (caller pre-scales like
        fsg_model_trans_add's callers)."""
        self.links.append(FsgLink(src, dst, logprob, wid))

    def null_trans_add(self, src: int, dst: int, logprob: float):
        self.links.append(FsgLink(src, dst, logprob, -1))

    def add_log_prob(self, prob: float) -> float:
        return math.log(prob) / LN_BASE * self.lw

    # -- silence / alternates (fsg_search_add_silences equivalents) ---------

    def add_silence(self, silword: str, state: int, silprob: float):
        """Add a silence self-loop at `state` (-1 = every state)
        (fsg_model_add_silence, src/lm/fsg_model.c:395-420)."""
        wid = self.word_add(silword)
        logsilp = self.add_log_prob(silprob)
        states = range(self.n_state) if state < 0 else [state]
        for s in states:
            self.trans_add(s, s, logsilp, wid)

    def add_alt(self, baseword: str, altword: str) -> int:
        """Duplicate every transition labeled `baseword` with `altword`
        at the same probability (fsg_model_add_alt)."""
        bwid = self.word_id(baseword)
        if bwid < 0:
            return 0
        awid = self.word_add(altword)
        n = 0
        for l in list(self.links):
            if l.wid == bwid:
                self.trans_add(l.src, l.dst, l.logprob, awid)
                n += 1
        return n

    # -- null closure --------------------------------------------------------

    def null_closure(self) -> np.ndarray:
        """[S, S] best epsilon-path log score (Floyd-Warshall max-plus);
        -inf where unreachable, 0 on the diagonal."""
        S = self.n_state
        C = np.full((S, S), -np.inf)
        np.fill_diagonal(C, 0.0)
        for l in self.links:
            if l.wid < 0:
                C[l.src, l.dst] = max(C[l.src, l.dst], l.logprob)
        for k in range(S):
            C = np.maximum(C, C[:, k:k + 1] + C[k:k + 1, :])
        return C

    # -- I/O -----------------------------------------------------------------

    @classmethod
    def readfile(cls, path: str, lw: float = 1.0) -> "FsgModel":
        name, n_state, start, final = "", None, 0, -1
        trans = []
        for raw in open(path):
            line = raw.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            key = parts[0]
            if key == "FSG_BEGIN":
                name = parts[1] if len(parts) > 1 else ""
            elif key in ("NUM_STATES", "N"):
                n_state = int(parts[1])
            elif key in ("START_STATE", "S"):
                start = int(parts[1])
            elif key in ("FINAL_STATE", "F"):
                final = int(parts[1])
            elif key in ("TRANSITION", "T"):
                src, dst = int(parts[1]), int(parts[2])
                prob = float(parts[3])
                word = parts[4] if len(parts) > 4 else None
                trans.append((src, dst, prob, word))
            elif key == "FSG_END":
                break
        if n_state is None:
            raise ValueError(f"{path}: no NUM_STATES declaration")
        fsg = cls(name=name, n_state=n_state, start_state=start,
                  final_state=final, lw=lw)
        for src, dst, prob, word in trans:
            if src >= n_state or dst >= n_state:
                raise ValueError(f"{path}: transition state out of range")
            lp = fsg.add_log_prob(prob) if prob > 0 else -np.inf
            if word is None:
                fsg.null_trans_add(src, dst, lp)
            else:
                fsg.trans_add(src, dst, lp, fsg.word_add(word))
        return fsg

    def writefile(self, path: str):
        with open(path, "w") as f:
            f.write(f"FSG_BEGIN {self.name}\n")
            f.write(f"NUM_STATES {self.n_state}\n")
            f.write(f"START_STATE {self.start_state}\n")
            f.write(f"FINAL_STATE {self.final_state}\n")
            for l in self.links:
                p = math.exp(l.logprob * LN_BASE / self.lw) \
                    if np.isfinite(l.logprob) else 0.0
                w = self.vocab[l.wid] if l.wid >= 0 else ""
                f.write(f"TRANSITION {l.src} {l.dst} {p:g} {w}\n".rstrip()
                        + "\n")
            f.write("FSG_END\n")
