"""Simple ARPA language-model builder from text (the reference's
cython/pocketsphinx/lm.py ArpaBoLM capability: fixed-discount backoff
trigram estimation from a training corpus).

A copy of `pocketsphinx_tpu.lm.arpabo` (host code)."""

from __future__ import annotations

import math
import re
from collections import defaultdict
from io import StringIO


class ArpaBoLM:
    """Fixed-discount backoff LM: P(w) scaled by (1 - discount_mass),
    with the discounted mass distributed via backoff weights."""

    def __init__(self, sentfile=None, text: str | None = None,
                 add_start: bool = False, word_file: str | None = None,
                 word_file_count: int = 1, discount_mass: float = 0.5,
                 case: str | None = None):
        if not 0.0 < discount_mass < 1.0:
            raise ValueError(f"discount_mass {discount_mass} out of (0,1)")
        self.discount = discount_mass
        self.deflator = 1.0 - discount_mass
        self.add_start = add_start
        self.case = case
        self.c1 = defaultdict(int)
        self.c2 = defaultdict(int)      # (w1, w2) -> count
        self.c3 = defaultdict(int)      # (w1, w2, w3) -> count
        self.sent_count = 0
        if sentfile is not None:
            self.read_corpus(sentfile)
        if text is not None:
            self.read_corpus(StringIO(text))
        if word_file is not None:
            with open(word_file) as f:
                for token in f:
                    token = self._norm(token.strip())
                    if token and token not in self.c1:
                        self.c1[token] = word_file_count

    def _norm(self, w: str) -> str:
        if self.case == "lower":
            return w.lower()
        if self.case == "upper":
            return w.upper()
        return w

    def read_corpus(self, infile):
        for line in infile:
            line = re.sub(r"(.+)\(.+\)$", r"\1", self._norm(line.strip()))
            words = line.split()
            if self.add_start and words:
                words = ["<s>"] + words + ["</s>"]
            if not words:
                continue
            self.sent_count += 1
            for j, w1 in enumerate(words):
                self.c1[w1] += 1
                if j + 1 < len(words):
                    self.c2[(w1, words[j + 1])] += 1
                    if j + 2 < len(words):
                        self.c3[(w1, words[j + 1], words[j + 2])] += 1

    def write(self, outfile):
        if not self.c1:
            raise ValueError("no training data")
        total = sum(self.c1.values())
        p1 = {w: c * self.deflator / total for w, c in self.c1.items()}
        succ2 = defaultdict(list)
        for (w1, w2), c in self.c2.items():
            succ2[w1].append(w2)
        a1 = {}
        for w1 in self.c1:
            denom = 1.0 - sum(p1[w2] for w2 in succ2.get(w1, ()))
            a1[w1] = self.discount / denom
        p2 = {(w1, w2): c * self.deflator / self.c1[w1]
              for (w1, w2), c in self.c2.items()}
        succ3 = defaultdict(list)
        for (w1, w2, w3), c in self.c3.items():
            succ3[(w1, w2)].append(w3)
        a2 = {}
        for (w1, w2) in self.c2:
            denom = 1.0 - sum(p2[(w2, w3)] for w3 in succ3.get((w1, w2), ())
                              if (w2, w3) in p2)
            a2[(w1, w2)] = self.discount / denom

        l10 = math.log(10.0)
        lg = lambda p: math.log(p) / l10
        outfile.write(f"Corpus: {self.sent_count} sentences; {total} words, "
                      f"{len(self.c1)} 1-grams, {len(self.c2)} 2-grams, "
                      f"{len(self.c3)} 3-grams, with fixed discount mass "
                      f"{self.discount}\n\n")
        outfile.write("\\data\\\n")
        outfile.write(f"ngram 1={len(self.c1)}\n")
        if self.c2:
            outfile.write(f"ngram 2={len(self.c2)}\n")
        if self.c3:
            outfile.write(f"ngram 3={len(self.c3)}\n")
        outfile.write("\n\\1-grams:\n")
        for w1 in sorted(p1):
            outfile.write(f"{lg(p1[w1]):6.4f} {w1} {lg(a1[w1]):6.4f}\n")
        if self.c2:
            outfile.write("\n\\2-grams:\n")
            for (w1, w2) in sorted(p2):
                outfile.write(f"{lg(p2[(w1, w2)]):6.4f} {w1} {w2} "
                              f"{lg(a2[(w1, w2)]):6.4f}\n")
        if self.c3:
            outfile.write("\n\\3-grams:\n")
            for (w1, w2, w3) in sorted(self.c3):
                p = self.c3[(w1, w2, w3)] * self.deflator / self.c2[(w1, w2)]
                outfile.write(f"{lg(p):6.4f} {w1} {w2} {w3}\n")
        outfile.write("\n\\end\\\n")

    def write_file(self, path: str):
        with open(path, "w") as f:
            self.write(f)


def to_textgrid(words, phones=None, outfile=None, frate: int = 100) -> str:
    """Alignment entries -> Praat TextGrid (cython/pocketsphinx/
    to_textgrid.py capability)."""
    end_time = max((w.start + w.duration) for w in words) / frate \
        if words else 0.0
    tiers = [("words", words)]
    if phones:
        tiers.append(("phones", phones))
    out = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
           "xmin = 0", f"xmax = {end_time:.3f}", "tiers? <exists>",
           f"size = {len(tiers)}", "item []:"]
    for ti, (name, entries) in enumerate(tiers, 1):
        out += [f"    item [{ti}]:", '        class = "IntervalTier"',
                f'        name = "{name}"', "        xmin = 0",
                f"        xmax = {end_time:.3f}",
                f"        intervals: size = {len(entries)}"]
        for i, e in enumerate(entries, 1):
            out += [f"        intervals [{i}]:",
                    f"            xmin = {e.start / frate:.3f}",
                    f"            xmax = {(e.start + e.duration) / frate:.3f}",
                    f'            text = "{e.text}"']
    text = "\n".join(out) + "\n"
    if outfile:
        with open(outfile, "w") as f:
            f.write(text)
    return text
