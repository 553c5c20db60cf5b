"""Language-model sets and class-based LMs (src/lm/ngram_model_set.c).

-lmctl file format: one "path name [{ class ... }]" per line, with an
optional leading "{ probdef ... }" naming class-definition files.
The probdef format defines LMCLASS blocks mapping member words to class
words with in-class probabilities; a class-based LM scores
P(member | hist) = P(class | hist) * P(member | class).

A copy of `pocketsphinx_tpu.lm.lmset` (host code).
"""

from __future__ import annotations

import math
import os
import re

from .ngram import NgramModel, read_lm, LN_BASE


class ClassDef:
    def __init__(self, name: str):
        self.name = name
        self.members: dict[str, float] = {}   # member word -> probability


def read_probdef(path: str) -> dict[str, ClassDef]:
    """Parse an LMCLASS probability-definition file."""
    classes: dict[str, ClassDef] = {}
    cur: ClassDef | None = None
    for raw in open(path):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("LMCLASS"):
            cur = ClassDef(line.split()[1])
            classes[cur.name] = cur
        elif line.startswith("END"):
            cur = None
        elif cur is not None:
            parts = line.split()
            word_class = parts[0]
            prob = float(parts[1]) if len(parts) > 1 else \
                1.0 / max(len(cur.members) + 1, 1)
            word = word_class.split(":")[0]
            cur.members[word] = prob
    return classes


class ClassNgramModel:
    """Wraps an NgramModel with word classes: class members score as
    P(class|hist) + log P(member|class) (ngram_model_set probdefs)."""

    def __init__(self, base: NgramModel, classes: dict[str, ClassDef]):
        self.base = base
        self.order = base.order
        self.counts = base.counts
        self.member_map: dict[str, tuple[int, float]] = {}
        for cd in classes.values():
            cwid = base.wid(cd.name)
            if cwid < 0:
                continue
            for member, prob in cd.members.items():
                self.member_map[member] = (
                    cwid, math.log(max(prob, 1e-12)) / LN_BASE)

    def wid(self, word: str) -> int:
        if word in self.member_map:
            return self.member_map[word][0]
        return self.base.wid(word)

    def raw_score(self, wid, hist, member: str | None = None):
        s = self.base.raw_score(wid, hist)
        if member is not None and member in self.member_map:
            s += self.member_map[member][1]
        return s

    def score_word(self, word: str, hist) -> float:
        if word in self.member_map:
            cwid, inprob = self.member_map[word]
            return self.base.raw_score(cwid, hist) + inprob
        w = self.base.wid(word)
        if w < 0:
            return float("-inf")
        return self.base.raw_score(w, hist)

    def __getattr__(self, name):
        return getattr(self.base, name)


class InterpolatedNgramModel:
    """Weighted interpolation over a set's members
    (ngram_model_set_score with cur == -1,
    src/lm/ngram_model_set.c:685-732): score(w|h) =
    logadd_i(lweight_i + member_i's weighted score), each member scored
    with its own lw/wip, word/history mapped per member by string."""

    def __init__(self, models: dict, lweights: dict):
        self.models = models
        self.lweights = lweights          # name -> log-weight (logmath)
        first = next(iter(models.values()))
        self.order = max(m.order for m in models.values())
        self.counts = first.counts
        # union vocabulary, first model's ids first (widmap analog)
        self.words = list(first.words)
        self._wid = {w: i for i, w in enumerate(self.words)}
        for m in models.values():
            for w in m.words:
                if w not in self._wid:
                    self._wid[w] = len(self.words)
                    self.words.append(w)

    def wid(self, word: str) -> int:
        w = self._wid.get(word, -1)
        if w < 0:
            w = self._wid.get(word.lower(), -1)
        return w

    def score_word(self, word: str, hist_words) -> float:
        """Interpolated weighted score in logmath units; hist_words is
        the word-string history (oldest..newest)."""
        acc = None
        for name, m in self.models.items():
            hist = [m.wid(h) for h in hist_words]
            hist = [h for h in hist if h >= 0]
            if hasattr(m, "score_word"):
                s = m.score_word(word, hist)
            else:
                w = m.wid(word)
                if w < 0:
                    continue
                s = m.raw_score(w, hist) * m.lw + m.log_wip
            t = self.lweights[name] + s
            if acc is None:
                acc = t
            else:
                # log-add in base-1.0001 log domain
                acc = math.log(math.exp(acc * LN_BASE)
                               + math.exp(t * LN_BASE)) / LN_BASE
        return acc if acc is not None else float("-inf")


class NgramModelSet:
    """Named collection of LMs with one active OR interpolated
    (ngram_model_set): supports -lmctl/-lmname, runtime switching
    (ngram_model_set_select) and weighted interpolation
    (ngram_model_set_interp, src/lm/ngram_model_set.c:494)."""

    def __init__(self, lw: float = 1.0, wip: float = 1.0):
        self.models: dict[str, NgramModel | ClassNgramModel] = {}
        self.active: str | None = None
        self.lw = lw
        self.wip = wip
        #: per-model interpolation log-weights (logmath units);
        #: initialized uniform as models are added (ngram_model_set_init)
        self.lweights: dict[str, float] = {}
        self.interpolating = False

    @classmethod
    def read_lmctl(cls, path: str, lw: float = 1.0,
                   wip: float = 1.0) -> "NgramModelSet":
        ms = cls(lw, wip)
        base_dir = os.path.dirname(os.path.abspath(path))
        text = open(path).read()
        toks = re.findall(r"\{[^}]*\}|\S+", text)
        probdefs: dict[str, ClassDef] = {}
        i = 0
        # optional leading { probdef files }
        if toks and toks[0].startswith("{"):
            for pd in toks[0].strip("{} \n").split():
                pd_path = os.path.join(base_dir, pd)
                if os.path.isfile(pd_path):
                    probdefs.update(read_probdef(pd_path))
            i = 1
        while i < len(toks):
            lm_file = toks[i]
            i += 1
            if i >= len(toks):
                break
            name = toks[i]
            i += 1
            class_names: list[str] = []
            if i < len(toks) and toks[i].startswith("{"):
                class_names = toks[i].strip("{} \n").split()
                i += 1
            lm_path = os.path.join(base_dir, lm_file)
            if not os.path.isfile(lm_path):
                continue
            m = read_lm(lm_path, lw=lw, wip=wip)
            if class_names:
                use = {n: probdefs[n] for n in class_names if n in probdefs}
                m = ClassNgramModel(m, use)
            ms.add(name, m)
        return ms

    def add(self, name: str, model, weight: float = 1.0,
            reuse_widmap: bool = False):
        """Add a model; interpolation weights renormalize like
        ngram_model_set_add (new = weight/n, others scaled by 1-new)."""
        self.models[name] = model
        n = len(self.models)
        fprob = min(max(weight * 1.0 / n, 1e-30), 1.0 - 1e-12) \
            if n > 1 else 1.0
        scale = math.log(1.0 - fprob) / LN_BASE if n > 1 else 0.0
        for k in self.lweights:
            self.lweights[k] += scale
        self.lweights[name] = math.log(fprob) / LN_BASE
        if self.active is None and not self.interpolating:
            self.active = name

    def interp(self, names=None, weights=None):
        """Enable interpolated scoring (ngram_model_set_interp): with
        (names, weights) set those models' weights (linear probs,
        renormalized over the full set is the caller's concern, as in
        the reference); with neither, just enable existing weights.
        Returns the InterpolatedNgramModel facade."""
        if names is not None and weights is not None:
            for n, w in zip(names, weights):
                if n not in self.models:
                    raise KeyError(f"Unknown LM name {n!r}")
                self.lweights[n] = math.log(max(w, 1e-30)) / LN_BASE
        elif weights is not None:
            for k, w in zip(list(self.models), weights):
                self.lweights[k] = math.log(max(w, 1e-30)) / LN_BASE
        elif not self.lweights:
            u = math.log(1.0 / max(len(self.models), 1)) / LN_BASE
            self.lweights = {k: u for k in self.models}
        self.interpolating = True
        self.active = None                 # cur = -1
        return InterpolatedNgramModel(self.models, dict(self.lweights))

    def select(self, name: str):
        if name not in self.models:
            raise KeyError(f"No LM named {name!r}")
        self.active = name
        self.interpolating = False
        return self.models[name]

    def current(self):
        if self.interpolating:
            return InterpolatedNgramModel(self.models, dict(self.lweights))
        return self.models[self.active] if self.active else None

    def __iter__(self):
        return iter(self.models)

    def __len__(self):
        return len(self.models)
