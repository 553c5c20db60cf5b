"""Pronunciation dictionary (src/dict.c re-design).

Text format: one pronunciation per line, "WORD PH1 PH2 ...", alternates
as "WORD(2) ...".  Comment lines start with "##" or ";;".  The filler
dictionary (noisedict) marks its words as fillers.  <s>, </s>, <sil> are
added with the silence phone if absent (src/dict.c:343-386).
"""

from __future__ import annotations

import re

import numpy as np

from .bin_mdef import BinMdef

START_WORD = "<s>"
FINISH_WORD = "</s>"
SILENCE_WORD = "<sil>"

_PAREN = re.compile(r"^(.*)\((\d+)\)$")


class Dictionary:
    def __init__(self, mdef: BinMdef, dict_path: str | None = None,
                 filler_path: str | None = None, dictcase: bool = False):
        self.mdef = mdef
        self.dictcase = dictcase
        self.words: list[str] = []          # full name incl. (n) suffix
        self.prons: list[np.ndarray] = []   # CI phone id arrays
        self.filler: list[bool] = []
        self.basewid: list[int] = []        # base word id for alternates
        self.alt: list[int] = []            # next alternate wid or -1
        self._index: dict[str, int] = {}    # word -> first (base) wid
        if dict_path:
            self._load(dict_path, False)
        if filler_path:
            self._load(filler_path, True)
        sil = mdef.sil
        for w in (START_WORD, FINISH_WORD, SILENCE_WORD):
            if self.wordid(w) < 0:
                self.add_word(w, [sil], filler=True)
        self.startwid = self.wordid(START_WORD)
        self.finishwid = self.wordid(FINISH_WORD)
        self.silwid = self.wordid(SILENCE_WORD)

    def _norm(self, w: str) -> str:
        # dict.c:332 wires the "dictcase" config flag directly into the
        # nocase hash + nocase phone lookup (dict_ciphone_id, :56-61):
        # dictcase=true means case-INsensitive, despite the flag's doc
        # string.  Behavior parity wins over the doc.
        return w.lower() if self.dictcase else w

    def _load(self, path: str, filler: bool):
        bad = 0
        for line in open(path, encoding="utf-8", errors="replace"):
            line = line.strip()
            if not line or line.startswith("##") or line.startswith(";;"):
                continue
            parts = line.split()
            word, phones = parts[0], parts[1:]
            pids = []
            ok = True
            for ph in phones:
                p = self.mdef.ciphone_id(ph, nocase=self.dictcase)
                if p < 0:
                    ok = False
                    break
                pids.append(p)
            if not ok or not pids:
                bad += 1
                continue
            self.add_word(word, pids, filler=filler)

    def add_word(self, word: str, phones, filler: bool = False) -> int:
        """dict_add_word: register a word (possibly an alternate
        "word(n)"); returns the new wid or -1."""
        word = self._norm(word)
        m = _PAREN.match(word)
        base_name = m.group(1) if m else word
        wid = len(self.words)
        self.words.append(word)
        self.prons.append(np.asarray(phones, dtype=np.int32))
        self.filler.append(filler)
        base = self._index.get(base_name, wid)
        self.basewid.append(base)
        self.alt.append(-1)
        if base != wid:
            # link into the base word's alternate chain (head insert)
            self.alt[wid] = self.alt[base]
            self.alt[base] = wid
        if base_name not in self._index:
            self._index[base_name] = wid
        return wid

    # -- queries -------------------------------------------------------------

    def __len__(self):
        return len(self.words)

    def wordid(self, word: str) -> int:
        return self._index.get(self._norm(word), -1)

    def wordstr(self, wid: int) -> str:
        return self.words[wid]

    def basestr(self, wid: int) -> str:
        """Word string without the (n) alternate suffix."""
        m = _PAREN.match(self.words[wid])
        return m.group(1) if m else self.words[wid]

    def pron(self, wid: int) -> np.ndarray:
        return self.prons[wid]

    def pronlen(self, wid: int) -> int:
        return len(self.prons[wid])

    def is_filler(self, wid: int) -> bool:
        # <s> and </s> count as fillers for search purposes
        # (dict_filler_word, src/dict.c:60-75)
        return bool(self.filler[wid]) or wid in (self.startwid, self.finishwid)

    def alternates(self, wid: int):
        """Yield all wids sharing this word's base (incl. itself)."""
        w = self.basewid[wid]
        yield w
        a = self.alt[w]
        while a >= 0:
            yield a
            a = self.alt[a]
