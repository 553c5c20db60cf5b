"""N-gram language model: ARPA and trie-binary (.lm.bin) readers + scoring.

Re-design of the reference LM stack (src/lm/ngram_model.c,
ngram_model_trie.c, lm_trie.c, lm_trie_quant.c, bitarr.c): instead of
bit-packed trie *storage* with per-query walks, the loader decodes every
n-gram level into flat NumPy arrays (words / probs / backoffs / child
ranges).  Scoring is standard Katz backoff; for the device decoder the model
materializes *dense successor tables* (all-words score vectors per
history), which is what the batched word-transition matmul consumes —
the device-resident-LM plan of SURVEY.md §2.2.

Probabilities are floats in log base 1.0001 ("unshifted logmath units"),
exactly as the trie file stores them; `score()` applies
`raw * lw + log(wip)` like trie_apply_weights/weight_score
(src/lm/ngram_model_trie.c:701-713).

.lm.bin layout (src/lm/ngram_model_trie.c:372-440, lm_trie.c:400-414,
lm_trie_quant.c:111-147, bitarr.c):
    "Trie Language Model" | uint8 order | uint32 counts[order]
    int32 quant_type_dummy | float32 quant_values[(order-2)*2^17 + 2^16]
    unigram_t[counts[0]+1] = {float prob, float bo, uint32 next}
    per middle order i=2..order-1: bit-packed entries
        [word:W][prob_idx:16][bo_idx:16][next:N], (counts[i-1]+1) slots
        + 8 guard bytes; W = bits(counts[0]), N = bits(counts[i])
    longest order: [word:W][prob_idx:16], (counts[N-1]+1) slots + 8 guard
    int32 strlen | NUL-separated word strings
"""

from __future__ import annotations

import bz2
import gzip
import math
from dataclasses import dataclass, field

import numpy as np

LN_BASE = math.log(1.0001)
LOG10_TO_LOG = math.log(10.0) / LN_BASE


def _required_bits(maxval: int) -> int:
    if maxval == 0:
        return 0
    r = 1
    while maxval >> 1:
        maxval >>= 1
        r += 1
    return r


def _read_bits(mem: np.ndarray, offsets: np.ndarray, nbits: int) -> np.ndarray:
    """Vectorized little-endian bit-field extraction (bitarr_read_int25/57)."""
    byte_off = (offsets >> 3).astype(np.int64)
    shift = (offsets & 7).astype(np.uint64)
    # gather 8 bytes per offset
    idx = byte_off[:, None] + np.arange(8)[None, :]
    window = mem[idx].astype(np.uint64)
    val = (window << (np.arange(8, dtype=np.uint64) * np.uint64(8))[None, :]).sum(
        axis=1, dtype=np.uint64)
    mask = np.uint64((1 << nbits) - 1)
    return ((val >> shift) & mask).astype(np.int64)


@dataclass
class NgramModel:
    order: int
    counts: list[int]
    words: list[str]
    # per level l (0-based): arrays over entries of that level
    lv_words: list[np.ndarray] = field(default_factory=list)
    lv_prob: list[np.ndarray] = field(default_factory=list)
    lv_bo: list[np.ndarray] = field(default_factory=list)
    lv_next: list[np.ndarray] = field(default_factory=list)   # child begin per entry (+1 slot)
    lw: float = 1.0
    log_wip: float = 0.0

    def __post_init__(self):
        self._wid = {w: i for i, w in enumerate(self.words)}
        self._maps: list[dict] = [None] * self.order
        # level 1 (bigram) parent = unigram id; build (h, w) -> entry maps
        # lazily per level for scoring
        self._succ_cache: dict = {}

    # -- word ids ------------------------------------------------------------

    def wid(self, word: str) -> int:
        w = self._wid.get(word, -1)
        if w < 0:
            # case folding like ngram_wid's lookup chain
            w = self._wid.get(word.lower(), -1)
        return w

    @property
    def n_words(self):
        return self.counts[0]

    def apply_weights(self, lw: float, wip: float):
        self.lw = lw
        self.log_wip = math.log(wip) / LN_BASE
        self._succ_cache.clear()
        return self

    def add_word(self, word: str, weight: float = 1.0) -> int:
        """Add `word` as a new unigram with raw probability
        weight/(n_unigrams+1), no backoff weight and no bigram children
        (ngram_model_add_word src/lm/ngram_model.c:662 +
        lm_trie_add_ug src/lm/ngram_model_trie.c:745).  Existing
        unigrams are deliberately NOT renormalized, matching the
        reference.  Returns the new (or existing) word id."""
        if word in self._wid:
            import warnings
            warnings.warn(f"Omit duplicate word {word!r}")
            return self._wid[word]
        V = self.counts[0]
        wid = V
        self.words = list(self.words) + [word]
        lweight = np.float32(
            (math.log(max(weight, 1e-30)) + math.log(1.0 / (V + 1)))
            / LN_BASE)
        # insert before any sentinel slots the trie reader may keep
        self.lv_prob[0] = np.insert(self.lv_prob[0], V, lweight)
        self.lv_bo[0] = np.insert(self.lv_bo[0], V, np.float32(0.0))
        self.lv_words[0] = np.arange(len(self.lv_prob[0]), dtype=np.int64)
        if self.order >= 2 and len(self.lv_next) \
                and self.lv_next[0] is not None:
            nxt = self.lv_next[0]
            ins = nxt[V] if V < len(nxt) else nxt[-1]
            self.lv_next[0] = np.insert(nxt, V, ins)  # zero children
        self.counts[0] = V + 1
        self._wid[word] = wid
        self._maps = [None] * self.order
        self._succ_cache.clear()
        return wid

    # -- entry lookup --------------------------------------------------------

    def _level_map(self, level: int) -> dict:
        """(parent_entry, word) -> entry index for level >= 1."""
        if self._maps[level] is None:
            parents = self._parents(level)
            self._maps[level] = {
                (int(p), int(w)): i
                for i, (p, w) in enumerate(zip(parents, self.lv_words[level]))}
        return self._maps[level]

    def _parents(self, level: int) -> np.ndarray:
        """Parent entry index for each entry of `level` (from the child
        ranges of level-1)."""
        return _range_owner(self.lv_next[level - 1],
                            len(self.lv_words[level - 1]),
                            len(self.lv_words[level]))

    def _find(self, hist: list[int]) -> tuple[int, int]:
        """Locate the entry for word sequence hist (oldest..newest);
        returns (level, entry) or (-1, -1)."""
        if not hist:
            return -1, -1
        e = hist[0]
        if e < 0 or e >= self.counts[0]:
            return -1, -1
        lvl = 0
        for w in hist[1:]:
            m = self._level_map(lvl + 1)
            e2 = m.get((e, int(w)))
            if e2 is None:
                return -1, -1
            e = e2
            lvl += 1
        return lvl, e

    # -- scoring -------------------------------------------------------------

    def raw_score(self, wid: int, hist: list[int]) -> float:
        """Katz backoff score of P(wid | hist) (hist oldest..newest) in
        float logmath units (lm_trie_score semantics)."""
        hist = [h for h in hist if h >= 0][-(self.order - 1):]
        for n in range(len(hist), -1, -1):
            lvl, e = self._find(hist[len(hist) - n:] + [wid])
            if lvl >= 0:
                prob = float(self.lv_prob[lvl][e])
                # add backoffs of the unmatched longer histories
                bo = 0.0
                for k in range(n + 1, len(hist) + 1):
                    blvl, be = self._find(hist[len(hist) - k:])
                    if blvl >= 0:
                        bo += float(self.lv_bo[blvl][be])
                return prob + bo
        return float(self.lv_prob[0][0])  # should not happen (<unk>)

    def score(self, wid: int, hist: list[int]) -> int:
        return int(self.raw_score(wid, hist) * self.lw + self.log_wip)

    # -- dense successor tables (device decode path) -------------------------

    def successor_row(self, hist: tuple[int, ...]) -> np.ndarray:
        """Dense weighted scores [n_words] of every word following `hist`
        (oldest..newest), with lw/wip applied — one row of the device LM
        table."""
        key = tuple(hist)
        if key in self._succ_cache:
            return self._succ_cache[key]
        row = self._raw_successor_row(list(hist))
        row = row * self.lw + self.log_wip
        self._succ_cache[key] = row.astype(np.float32)
        return self._succ_cache[key]

    def _raw_successor_row(self, hist: list[int]) -> np.ndarray:
        hist = [h for h in hist if h >= 0][-(self.order - 1):]
        # base: full backoff to unigrams
        row = self.lv_prob[0][:self.counts[0]].astype(np.float64)
        bo_sum = 0.0
        for k in range(1, len(hist) + 1):
            blvl, be = self._find(hist[len(hist) - k:])
            if blvl < 0:
                continue
        # overlay progressively longer matches
        # accumulate backoff weights bottom-up: start with sum of all
        # history backoffs, peel off as longer contexts match
        bo = np.zeros(len(hist) + 1)
        for k in range(1, len(hist) + 1):
            blvl, be = self._find(hist[len(hist) - k:])
            bo[k] = float(self.lv_bo[blvl][be]) if blvl >= 0 else 0.0
        total_bo = bo[1:].sum()
        row = row + total_bo
        for k in range(1, len(hist) + 1):
            ctx = hist[len(hist) - k:]
            lvl, e = self._find(ctx)
            if lvl < 0:
                continue
            nxt = self.lv_next[lvl]
            beg, end = int(nxt[e]), int(nxt[e + 1])
            if beg >= end:
                continue
            ws = self.lv_words[lvl + 1][beg:end]
            probs = self.lv_prob[lvl + 1][beg:end].astype(np.float64)
            # backoff applies only to the *longer* unmatched contexts
            rem_bo = bo[k + 1:].sum()
            row[ws] = probs + rem_bo
        return row

    def bigram_matrix(self) -> np.ndarray:
        """Dense [V, V] weighted bigram score matrix (rows = history)."""
        return np.stack([self.successor_row((h,))
                         for h in range(self.counts[0])])

    # -- dense per-context successor tables (exact-trigram decode path) ------

    def bigram_entries(self) -> tuple[np.ndarray, np.ndarray]:
        """(h_old [n_bg], h_new [n_bg]) word ids for every level-1 (bigram)
        entry, i.e. every explicit 2-word context the LM knows.  Entry b
        is the trigram context (h_old[b], h_new[b])."""
        if self.order < 2 or not len(self.lv_words[1]):
            z = np.zeros(0, np.int64)
            return z, z
        return self._parents(1), self.lv_words[1].astype(np.int64)

    def dense_context_rows(self, cols: np.ndarray,
                           budget_bytes: int = 2 << 30,
                           chunk: int = 2048):
        """Stacked dense successor-score table for the device decoder.

        cols [C]: LM word id per output column (decoder word order).
        Returns (rows [R, C] float32 weighted scores, with_tri bool):

          rows[0]        = P(col | <empty history>)        (unigram row)
          rows[1 + h]    = P(col | h)        for h in [0, V)  (bigram rows)
          rows[1+V + b]  = P(col | ctx_b)    for every level-1 entry b
                           (exact trigram successor rows), present only
                           when order >= 3 and the table fits the budget.

        Every row is numerically identical (float32) to successor_row()
        of the corresponding history: the Katz backoff recursion
        P(w|a,b) = tg(a,b,w) if seen else bo(a,b) + P(w|b), and
        P(w|b) = bg(b,w) if seen else bo(b) + P(w), is materialized by
        overlaying explicit-child probabilities on broadcast backoff
        rows (src/lm/lm_trie.c:400-414 reformulated as dense tensors)."""
        V = self.counts[0]
        C = len(cols)
        cols = np.asarray(cols, dtype=np.int64)
        n_bg = self.counts[1] if self.order >= 2 else 0
        with_tri = (self.order >= 3 and n_bg > 0
                    and (1 + V + n_bg) * C * 4 <= budget_bytes)
        R = 1 + V + (n_bg if with_tri else 0)
        rows = np.empty((R, C), dtype=np.float32)

        uni = self.lv_prob[0][:V].astype(np.float32)
        bo1 = self.lv_bo[0][:V].astype(np.float32)

        def bigram_rows_fw(hs: np.ndarray) -> np.ndarray:
            """Full-width [len(hs), V] exact P(. | h) rows."""
            B = uni[None, :] + bo1[hs, None]
            if n_bg:
                nxt0 = self.lv_next[0]
                w1 = self.lv_words[1]
                p1 = self.lv_prob[1].astype(np.float32)
                for i, h in enumerate(hs):
                    beg, end = int(nxt0[h]), int(nxt0[h + 1])
                    if beg < end:
                        B[i, w1[beg:end]] = p1[beg:end]
            return B

        rows[0] = uni[cols]
        all_h = np.arange(V, dtype=np.int64)
        for h0 in range(0, V, chunk):
            h1 = min(h0 + chunk, V)
            rows[1 + h0:1 + h1] = bigram_rows_fw(all_h[h0:h1])[:, cols]
        if with_tri:
            w1 = self.lv_words[1].astype(np.int64)
            bo2 = self.lv_bo[1].astype(np.float32)
            par2 = self._parents(2)
            w2 = self.lv_words[2]
            probs2 = self.lv_prob[2].astype(np.float32)
            nxt1 = self.lv_next[1]
            for b0 in range(0, n_bg, chunk):
                b1 = min(b0 + chunk, n_bg)
                # backoff base: bigram row of the newest history word
                T = bigram_rows_fw(w1[b0:b1]) + bo2[b0:b1, None]
                # overlay explicit trigram children of these contexts
                lo, hi = int(nxt1[b0]), int(nxt1[b1])
                T[par2[lo:hi] - b0, w2[lo:hi]] = probs2[lo:hi]
                rows[1 + V + b0:1 + V + b1] = T[:, cols]
        rows *= np.float32(self.lw)
        rows += np.float32(self.log_wip)
        return rows, with_tri

    def bigram_rows_dense(self, cols: np.ndarray,
                          chunk: int = 2048) -> np.ndarray:
        """[V+1, C] weighted bigram successor table: row h < V is the
        exact P(col | h) Katz row, row V is the empty-history (unigram)
        row.  The scalable decoder path ("mode B") pairs this with
        sparse per-context trigram corrections instead of materializing
        a row per trigram context (src/lm/lm_trie.c:400-414 semantics
        at O(V*C) memory)."""
        V = self.counts[0]
        cols = np.asarray(cols, dtype=np.int64)
        C = len(cols)
        n_bg = self.counts[1] if self.order >= 2 else 0
        uni = self.lv_prob[0][:V].astype(np.float32)
        bo1 = self.lv_bo[0][:V].astype(np.float32)
        out = np.empty((V + 1, C), dtype=np.float32)
        out[V] = uni[cols]
        nxt0 = self.lv_next[0] if n_bg else None
        w1 = self.lv_words[1] if n_bg else None
        p1 = self.lv_prob[1].astype(np.float32) if n_bg else None
        for h0 in range(0, V, chunk):
            h1 = min(h0 + chunk, V)
            B = uni[None, :] + bo1[h0:h1, None]
            if n_bg:
                for i in range(h0, h1):
                    beg, end = int(nxt0[i]), int(nxt0[i + 1])
                    if beg < end:
                        B[i - h0, w1[beg:end]] = p1[beg:end]
            out[h0:h1] = B[:, cols]
        out *= np.float32(self.lw)
        out += np.float32(self.log_wip)
        return out

    def bigram_csr(self, cols: np.ndarray, skip: np.ndarray | None = None):
        """Per-history sparse bigram successor lists for the fully-sparse
        "mode C" decoder LM path (135k-word scale, where even the dense
        [V+1, C] bigram table of mode B is O(V*C) ~ 75 GB;
        src/lm/lm_trie.c:400-414 contract at O(n_bigrams) memory).

        Returns (bg_next [V+2] int64 CSR ranges, bg_cols int32 output
        columns, bg_vals f32 weighted explicit bigram scores, bg_ctx
        f32 successor context ids 1+V+b): for history h, entries
        bg_next[h]:bg_next[h+1] override the unigram-backoff base row
        uni[c] + bo1w[h].  Entries are expanded per duplicate output
        column (alternate pronunciations); columns with skip True
        (fillers) are excluded.  Row V (empty history) is empty."""
        V = self.counts[0]
        cols = np.asarray(cols, dtype=np.int64)
        n_bg = self.counts[1] if self.order >= 2 else 0
        if not n_bg:
            return (np.zeros(V + 2, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.float32), np.zeros(0, np.float32))
        w1 = self.lv_words[1].astype(np.int64)
        p1 = (self.lv_prob[1].astype(np.float32) * np.float32(self.lw)
              + np.float32(self.log_wip))
        par1 = self._parents(1)
        # map LM word -> output columns (duplicates for alternates)
        keep = np.ones(len(cols), bool) if skip is None else ~np.asarray(skip)
        kidx = np.nonzero(keep)[0]
        order = np.argsort(cols[kidx], kind="stable")
        skey = cols[kidx][order]
        beg = np.searchsorted(skey, w1)
        end = np.searchsorted(skey, w1, side="right")
        cnt = end - beg
        tot = int(cnt.sum())
        base = np.repeat(beg, cnt)
        within = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        bg_cols = kidx[order[base + within]].astype(np.int32)
        bg_vals = np.repeat(p1, cnt).astype(np.float32)
        bg_ctx = np.repeat(1 + V + np.arange(n_bg), cnt).astype(np.float32)
        bg_par = np.repeat(par1, cnt)
        bg_next = np.zeros(V + 2, np.int64)
        np.add.at(bg_next, bg_par + 1, 1)
        bg_next = np.cumsum(bg_next)
        return bg_next, bg_cols, bg_vals, bg_ctx

    def trigram_corrections(self, cols: np.ndarray):
        """Per-bigram-context sparse trigram overrides for mode B.

        Returns (tgc_next [n_bg+1] int64 CSR ranges, tg_cols int32,
        tg_vals f32, bo2w [n_bg] f32): for bigram-entry context b,
        entries tgc_next[b]:tgc_next[b+1] give the output columns whose
        score is replaced by the explicit weighted trigram probability;
        bo2w[b] is the weighted trigram backoff added to the bigram row
        otherwise.  Columns are expanded per duplicate (alternate
        pronunciations map several decoder columns to one LM word)."""
        V = self.counts[0]
        cols = np.asarray(cols, dtype=np.int64)
        n_bg = self.counts[1] if self.order >= 2 else 0
        if self.order < 3 or not n_bg or not len(self.lv_words[2]):
            return (np.zeros(n_bg + 1, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.float32),
                    np.zeros(max(n_bg, 0), np.float32))
        bo2w = (self.lv_bo[1].astype(np.float32)
                * np.float32(self.lw))
        par2 = self._parents(2)
        w2 = self.lv_words[2].astype(np.int64)
        p2 = (self.lv_prob[2].astype(np.float32) * np.float32(self.lw)
              + np.float32(self.log_wip))
        # map LM word -> output columns (duplicates for alternates)
        order = np.argsort(cols, kind="stable")
        skey = cols[order]
        beg = np.searchsorted(skey, w2)
        end = np.searchsorted(skey, w2, side="right")
        cnt = end - beg
        tot = int(cnt.sum())
        base = np.repeat(beg, cnt)
        within = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        tg_cols = order[base + within].astype(np.int32)
        tg_vals = np.repeat(p2, cnt)
        tg_par = np.repeat(par2, cnt)
        # group by parent context (par2 already sorted ascending)
        tgc_next = np.zeros(n_bg + 1, np.int64)
        np.add.at(tgc_next, tg_par + 1, 1)
        tgc_next = np.cumsum(tgc_next)
        return tgc_next, tg_cols, tg_vals.astype(np.float32), bo2w

    # -- perplexity (pocketsphinx_lm_eval equivalent) ------------------------

    def sentence_score(self, words: list[str], start="<s>", end="</s>"):
        """Total weighted log prob and per-word raw scores for a sentence."""
        hist = []
        s = self.wid(start)
        if s >= 0:
            hist.append(s)
        total = 0.0
        n = 0
        for w in list(words) + [end]:
            wid = self.wid(w)
            if wid < 0:
                continue
            total += self.raw_score(wid, hist)
            hist = (hist + [wid])[-(self.order - 1):]
            n += 1
        return total, n


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def _open_maybe_compressed(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    if path.endswith(".bz2"):
        return bz2.open(path, "rb")
    return open(path, "rb")


def read_lm(path: str, lw: float = 1.0, wip: float = 1.0) -> NgramModel:
    """Auto-detecting LM reader (trie binary or ARPA, possibly
    compressed), mirroring ngram_model_read's format dispatch."""
    with _open_maybe_compressed(path) as f:
        head = f.read(24)
    if head.startswith(b"Trie Language Model"):
        m = read_trie_bin(path)
    elif head[4:20] == b"Darpa Trigram LM" or head[4:20] == \
            b"Darpa Trigram LM"[::-1]:
        m = read_dmp(path)
    else:
        try:
            m = read_arpa(path)
        except ValueError:
            m = read_dmp(path)
    return m.apply_weights(lw, wip)


def read_arpa(path: str) -> NgramModel:
    with _open_maybe_compressed(path) as f:
        text = f.read().decode("utf-8", errors="replace")
    lines = iter(text.splitlines())
    counts = []
    for line in lines:
        if line.strip() == "\\data\\":
            break
    for line in lines:
        line = line.strip()
        if line.startswith("ngram "):
            counts.append(int(line.split("=")[1]))
        elif line.startswith("\\"):
            break
        elif not line:
            continue
    order = len(counts)
    if order == 0:
        raise ValueError(f"{path}: no \\data\\ section")
    if order > 5:
        # NGRAM_MAX_ORDER == 5 (src/lm/ngram_model_internal.h:98); the
        # reference rejects such files with an "order" error
        # (test/regression/test-lm-convert.sh:50-75 expects failure)
        raise ValueError(f"{path}: ngram order {order} exceeds the "
                         "maximum order 5")
    words: list[str] = []
    widx: dict[str, int] = {}
    levels = [[] for _ in range(order)]   # (hist tuple, word, prob, bo)
    cur = 0  # current order being read (1-based); first section header consumed above
    # `line` currently holds "\\1-grams:" (or similar)
    def section_of(l):
        l = l.strip()
        if l.endswith("-grams:") and l.startswith("\\"):
            return int(l[1:l.index("-")])
        return None

    cur = section_of(line)
    for line in lines:
        ls = line.strip()
        if not ls:
            continue
        if ls == "\\end\\":
            break
        sec = section_of(ls)
        if sec is not None:
            cur = sec
            continue
        parts = ls.split()
        n = cur
        if len(parts) < n + 1:
            continue
        prob = float(parts[0]) * LOG10_TO_LOG
        grams = parts[1:n + 1]
        bo = float(parts[n + 1]) * LOG10_TO_LOG if len(parts) > n + 1 else 0.0
        if n == 1:
            w = grams[0]
            if w not in widx:
                widx[w] = len(words)
                words.append(w)
            ids = (widx[w],)
        else:
            try:
                ids = tuple(widx[g] for g in grams)
            except KeyError:
                continue
        levels[n - 1].append((ids, min(prob, 0.0), bo))
    if len(levels[0]) != counts[0]:
        # tolerate (reference warns); counts follow actual data
        counts[0] = len(levels[0])
    for i in range(1, order):
        if len(levels[i]) != counts[i]:
            raise ValueError(
                f"{path}: declared {counts[i]} {i + 1}-grams but "
                f"found {len(levels[i])} (not-enough/too-many-ngrams "
                "class of defect)")
    return _assemble(order, counts, words, levels)


def _level_arrays(entries, n):
    """A level's (ids [N, n] int64, prob, bo) from a list of (ids, prob,
    bo) tuples, or the arrays themselves."""
    if isinstance(entries, tuple):
        return entries
    ids = np.array([e[0] for e in entries], np.int64).reshape(-1, n)
    return (ids, np.array([e[1] for e in entries], np.float64),
            np.array([e[2] for e in entries], np.float64))


def _assemble(order, counts, words, levels) -> NgramModel:
    """Build flat level arrays with child ranges from each level's
    n-grams (forward word ids, oldest first; `_level_arrays`), sorting
    each level by (parent entry, word), stably.  An n-gram whose history
    is not an entry of the level below is dropped; of duplicate entries
    the last one is the parent of the level above."""
    V = len(words)
    ids0, p, b = _level_arrays(levels[0], 1)
    p0 = np.full(V, -99 * LOG10_TO_LOG, np.float32)
    b0 = np.zeros(V, np.float32)
    p0[ids0[:, 0]] = p
    b0[ids0[:, 0]] = b
    lv_words, lv_prob, lv_bo = [np.arange(V, dtype=np.int64)], [p0], [b0]
    lv_next, keys = [], [None]      # keys[l]: sorted parent*V + word

    def find(hist):
        """Entry index of each history [N, m] at level m-1, and whether
        it exists."""
        idx = hist[:, 0]
        ok = (idx >= 0) & (idx < V)
        for j in range(1, hist.shape[1]):
            key = idx * V + hist[:, j]
            pos = np.searchsorted(keys[j], key, side="right") - 1
            hit = pos >= 0
            hit[hit] = keys[j][pos[hit]] == key[hit]
            ok &= hit
            idx = np.where(ok, pos, 0)
        return idx, ok

    for lvl in range(1, order):
        ids, p, b = _level_arrays(levels[lvl], lvl + 1)
        pars, ok = find(ids[:, :-1])
        ws, pars = ids[ok, -1], pars[ok]
        srt = np.lexsort((ws, pars))
        ws, pars = ws[srt], pars[srt]
        n_par = len(lv_words[lvl - 1])
        lv_next.append(np.concatenate(
            [[0], np.cumsum(np.bincount(pars, minlength=n_par))]))
        lv_words.append(ws)
        lv_prob.append(np.asarray(p)[ok][srt].astype(np.float32))
        lv_bo.append(np.asarray(b)[ok][srt].astype(np.float32))
        keys.append(pars * V + ws)
    lv_next.append(np.zeros(len(lv_words[-1]) + 1, dtype=np.int64))
    return NgramModel(order=order, counts=list(counts), words=words,
                      lv_words=lv_words, lv_prob=lv_prob, lv_bo=lv_bo,
                      lv_next=lv_next[:order])


def write_arpa(model: NgramModel, path: str):
    """ARPA text writer (ngram_model_trie_write_arpa equivalent)."""
    inv = 1.0 / LOG10_TO_LOG

    def fmt(v):
        return f"{v * inv:.4f}"

    # reconstruct full id tuples per level
    paths = [[(w,) for w in range(model.counts[0])]]
    for lvl in range(1, model.order):
        par = model._parents(lvl)
        paths.append([paths[lvl - 1][int(p)] + (int(w),)
                      for p, w in zip(par, model.lv_words[lvl])])
    with open(path, "w") as f:
        f.write("\\data\\\n")
        for i, c in enumerate(model.counts):
            f.write(f"ngram {i + 1}={c}\n")
        for lvl in range(model.order):
            f.write(f"\n\\{lvl + 1}-grams:\n")
            has_bo = lvl < model.order - 1
            for i in range(len(model.lv_words[lvl])):
                grams = " ".join(model.words[w] for w in paths[lvl][i])
                line = f"{fmt(model.lv_prob[lvl][i])}\t{grams}"
                if has_bo and model.lv_bo[lvl][i] != 0.0:
                    line += f"\t{fmt(model.lv_bo[lvl][i])}"
                f.write(line + "\n")
        f.write("\n\\end\\\n")


def _write_bits(mem: bytearray, offset: int, nbits: int, value: int):
    """bitarr_write_int25/57: little-endian bit-field insert."""
    byte_off = offset >> 3
    shift = offset & 7
    cur = int.from_bytes(mem[byte_off:byte_off + 8], "little")
    cur |= (value & ((1 << nbits) - 1)) << shift
    mem[byte_off:byte_off + 8] = cur.to_bytes(8, "little")


def write_trie_bin(model: NgramModel, path: str):
    """Write the bit-packed reverse-trie .lm.bin format
    (lm_trie_write_bin, src/lm/lm_trie.c:437-460): the inverse of
    read_trie_bin, readable by the reference binary.

    Quantization bins hold the sorted unique prob/backoff values per
    level (exact when <= 2^16 distinct values, else quantile bins)."""
    order = model.order
    counts = [len(model.lv_words[l]) for l in range(order)]
    V = counts[0]

    # reconstruct forward tuples, then regroup as the reverse trie:
    # level l>=1 entry (h_l ... h_1 w): parent = (h_{l-1} ... h_1 w).
    paths = [[(w,) for w in range(V)]]
    for lvl in range(1, order):
        par = model._parents(lvl)
        paths.append([paths[lvl - 1][int(p)] + (int(w),)
                      for p, w in zip(par, model.lv_words[lvl])])

    def rev_key(ids):
        # forward (h_k ... h_1, w) -> trie path (w, h_1, ..., h_k)
        return (ids[-1],) + tuple(reversed(ids[:-1]))

    # order entries per level by (parent trie path, context key)
    lv_entries = []   # per level: list of (rev_path, prob, bo, fwd_index)
    for lvl in range(order):
        ents = []
        for i in range(counts[lvl]):
            rp = rev_key(paths[lvl][i])
            ents.append((rp, float(model.lv_prob[lvl][i]),
                         float(model.lv_bo[lvl][i]), i))
        ents.sort(key=lambda e: e[0])
        lv_entries.append(ents)

    def make_bins(values):
        u = np.unique(np.asarray(values, np.float32))
        if len(u) > (1 << 16):
            qs = np.quantile(u, np.linspace(0, 1, 1 << 16))
            u = np.unique(qs.astype(np.float32))
        bins = np.full(1 << 16, u[-1] if len(u) else 0.0, np.float32)
        bins[:len(u)] = u
        return bins

    def encode(bins, v):
        # lower_bound (lm_trie_quant bins_encode)
        return int(np.searchsorted(bins, np.float32(v), side="left"))

    out = bytearray()
    out += b"Trie Language Model"
    out += bytes([order])
    for c in counts:
        out += np.array([c], "<u4").tobytes()
    quant_parts = []
    mid_bins = []
    for lvl in range(1, order - 1):
        pb = make_bins([e[1] for e in lv_entries[lvl]])
        bb = make_bins([e[2] for e in lv_entries[lvl]])
        mid_bins.append((pb, bb))
        quant_parts += [pb, bb]
    longest_bins = make_bins([e[1] for e in lv_entries[order - 1]]) \
        if order > 1 else None
    if order > 1:
        quant_parts.append(longest_bins)
        out += np.array([1], "<i4").tobytes()   # quant type
        for q in quant_parts:
            out += q.astype("<f4").tobytes()

    # child ranges: entries of level l+1 grouped under level-l rev path
    child_begin = []
    for lvl in range(order - 1):
        parent_pos = {e[0]: k for k, e in enumerate(lv_entries[lvl])}
        nxt = np.zeros(counts[lvl] + 1, np.int64)
        for e in (lv_entries[lvl + 1] if lvl + 1 < order else []):
            nxt[parent_pos[e[0][:-1]] + 1] += 1
        child_begin.append(np.cumsum(nxt))

    # unigrams: trie order == word id order (rev path = (w,))
    uni = np.zeros(V + 1, dtype=np.dtype([("prob", "<f4"), ("bo", "<f4"),
                                          ("next", "<u4")]))
    for k, e in enumerate(lv_entries[0]):
        uni["prob"][k] = e[1]
        uni["bo"][k] = e[2]
    if order > 1:
        uni["next"][:V + 1] = child_begin[0]
    out += uni.tobytes()

    word_bits = _required_bits(V)
    for lvl in range(1, order):
        n = counts[lvl]
        is_longest = (lvl == order - 1)
        if is_longest:
            quant_bits, next_bits = 16, 0
        else:
            quant_bits, next_bits = 32, _required_bits(counts[lvl + 1])
        total_bits = word_bits + quant_bits + next_bits
        nbytes = ((1 + n) * total_bits + 7) // 8 + 8
        mem = bytearray(nbytes)
        for k, e in enumerate(lv_entries[lvl]):
            off = k * total_bits
            key = e[0][-1]          # deepest context word
            _write_bits(mem, off, word_bits, key)
            if is_longest:
                _write_bits(mem, off + word_bits, 16,
                            encode(longest_bins, e[1]))
            else:
                pb, bb = mid_bins[lvl - 1]
                _write_bits(mem, off + word_bits, 16, encode(bb, e[2]))
                _write_bits(mem, off + word_bits + 16, 16,
                            encode(pb, e[1]))
                _write_bits(mem, off + word_bits + quant_bits, next_bits,
                            int(child_begin[lvl][k]))
        if not is_longest:
            _write_bits(mem, n * total_bits + word_bits + quant_bits,
                        next_bits, int(child_begin[lvl][n]))
        out += bytes(mem)
    words_blob = b"\0".join(w.encode("utf-8") for w in model.words) + b"\0"
    out += np.array([len(words_blob)], "<i4").tobytes()
    out += words_blob
    with open(path, "wb") as f:
        f.write(out)


def write_dmp(model: NgramModel, path: str):
    """Legacy Sphinx DMP ("Darpa Trigram LM") binary *writer* — the
    inverse of read_dmp, producing files the reference binary reads
    (ngram_model_trie_read_dmp, src/lm/ngram_model_trie.c:489-690 +
    ngrams_raw_read_dmp, src/lm/ngrams_raw.c:236-360).

    Divergence note: the reference's own lm_convert advertises
    `-ofmt dmp` (programs/pocketsphinx_lm_convert.c:102-103) but its
    ngram_model_write supports only ARPA/BIN
    (src/lm/ngram_model.c:185-206) — DMP *write* is dead code there.
    This writer restores the full three-way conversion; correctness is
    checked by round-trip through read_dmp and by score parity.

    Format limits (inherent to DMP): trigram max order, 16-bit word ids
    (vocab < 65536), 16-bit quantized prob/backoff tables (values beyond
    2^16 distinct are quantile-binned), 512-entry trigram segment bases
    with 16-bit relative offsets."""
    order = model.order
    if order > 3:
        raise ValueError("DMP format supports at most trigram models")
    counts = [len(model.lv_words[l]) for l in range(order)]
    V = counts[0]
    if V >= (1 << 16):
        raise ValueError("DMP format limits vocabulary to 65535 words")
    bcount = counts[1] if order > 1 else 0
    tcount = counts[2] if order > 2 else 0
    inv = np.float32(1.0 / LOG10_TO_LOG)

    def quant_table(vals32):
        """Unique-value table + u16 index per entry (quantile-binned to
        nearest when > 2^16 distinct, like lm_trie_quant training)."""
        u = np.unique(vals32)
        if len(u) > (1 << 16):
            q = np.unique(np.quantile(
                u, np.linspace(0, 1, 1 << 16)).astype(np.float32))
            u = q
        idx = np.searchsorted(u, vals32)
        idx = np.clip(idx, 0, len(u) - 1)
        # snap to nearest of the two neighbors
        lo = np.clip(idx - 1, 0, len(u) - 1)
        idx = np.where(np.abs(u[lo] - vals32) < np.abs(u[idx] - vals32),
                       lo, idx)
        return u.astype(np.float32), idx.astype(np.uint16)

    out = bytearray()
    hdr = b"Darpa Trigram LM\0"
    out += np.array([len(hdr)], "<u4").tobytes() + hdr
    name = (path.rsplit("/", 1)[-1]).encode() + b"\0"
    out += np.array([len(name)], "<i4").tobytes() + name
    # version block: version <= 0 => timestamp + format strings until 0
    out += np.array([-7, 0, 0], "<i4").tobytes()   # version, ts, end-of-fmt
    out += np.array([V, bcount, tcount], "<i4").tobytes()

    p1 = (model.lv_prob[0].astype(np.float32) * inv)
    b1 = (model.lv_bo[0].astype(np.float32) * inv)
    unext = (model.lv_next[0].astype(np.int64) if order > 1
             else np.zeros(V + 1, np.int64))
    uni = np.zeros(V + 1, np.dtype([("mapid", "<i4"), ("prob", "<f4"),
                                    ("bo", "<f4"), ("next", "<i4")]))
    uni["mapid"][:V] = np.arange(V)
    uni["mapid"][V] = -1
    uni["prob"][:V] = p1
    uni["bo"][:V] = b1
    uni["next"] = unext
    out += uni.tobytes()

    if order > 1:
        prob2_tab, p2i = quant_table(
            model.lv_prob[1].astype(np.float32) * inv)
        if order > 2:
            bo2_tab, b2i = quant_table(
                model.lv_bo[1].astype(np.float32) * inv)
            prob3_tab, p3i = quant_table(
                model.lv_prob[2].astype(np.float32) * inv)
            tnext_abs = model.lv_next[1].astype(np.int64)   # [bcount+1]
            tseg = tnext_abs[np.arange(0, bcount + 1, 1 << 9)]
            next_rel = tnext_abs - tseg[np.arange(bcount + 1) >> 9]
            if next_rel.max(initial=0) >= (1 << 16):
                raise ValueError("DMP trigram segment overflow "
                                 "(>65535 trigrams in a 512-bigram block)")
        else:
            b2i = np.zeros(bcount, np.uint16)
            next_rel = np.zeros(bcount + 1, np.int64)
        bg = np.zeros(bcount + 1, np.dtype([("wid", "<u2"), ("p", "<u2"),
                                            ("b", "<u2"), ("next", "<u2")]))
        bg["wid"][:bcount] = model.lv_words[1].astype(np.uint16)
        bg["p"][:bcount] = p2i
        bg["b"][:bcount] = b2i
        bg["next"] = next_rel.astype(np.uint16)
        out += bg.tobytes()
        if order > 2:
            tg = np.zeros(tcount, np.dtype([("wid", "<u2"), ("p", "<u2")]))
            tg["wid"] = model.lv_words[2].astype(np.uint16)
            tg["p"] = p3i
            out += tg.tobytes()
        out += np.array([len(prob2_tab)], "<i4").tobytes() \
            + prob2_tab.tobytes()
        if order > 2:
            out += np.array([len(bo2_tab)], "<i4").tobytes() \
                + bo2_tab.tobytes()
            out += np.array([len(prob3_tab)], "<i4").tobytes() \
                + prob3_tab.tobytes()
            out += np.array([len(tseg)], "<i4").tobytes() \
                + tseg.astype("<i4").tobytes()
    words_blob = b"\0".join(w.encode("utf-8") for w in model.words) + b"\0"
    out += np.array([len(words_blob)], "<i4").tobytes() + words_blob
    with open(path, "wb") as f:
        f.write(bytes(out))


def read_dmp(path: str) -> NgramModel:
    """Legacy Sphinx DMP ("Darpa Trigram LM") binary reader
    (ngram_model_trie_read_dmp, src/lm/ngram_model_trie.c:489-690 +
    ngrams_raw_read_dmp, src/lm/ngrams_raw.c:236-360).

    Layout: u32 hdrlen + "Darpa Trigram LM\\0", u32 namelen + name,
    i32 version (<=0 => i32 timestamp + length-prefixed format strings
    until 0), i32 ucount/bcount/tcount; (ucount+1) x {i32 mapid,
    f32 log10 prob, f32 log10 bo, i32 first_bigram}; (bcount+1) x
    {u16 wid, prob_idx, bo_idx, next}; tcount x {u16 wid, prob_idx};
    f32 tables for prob2/bo2/prob3 (i32 len + values); i32 tseg_len +
    i32 tseg_base[]; NUL-separated word strings (i32 len prefix)."""
    with _open_maybe_compressed(path) as f:
        data = f.read()
    hdr = b"Darpa Trigram LM"
    k = int(np.frombuffer(data, "<u4", 1, 0)[0])
    en = "<"
    if k != len(hdr) + 1:
        k = int(np.frombuffer(data, ">u4", 1, 0)[0])
        if k != len(hdr) + 1:
            raise ValueError(f"{path}: not a DMP file")
        en = ">"
    pos = 4
    if data[pos:pos + len(hdr)] != hdr:
        raise ValueError(f"{path}: bad DMP header")
    pos += k

    def rd_i32():
        nonlocal pos
        v = int(np.frombuffer(data, en + "i4", 1, pos)[0])
        pos += 4
        return v

    k = rd_i32()
    pos += k            # LM file name
    vn = rd_i32()
    if vn <= 0:
        rd_i32()        # timestamp
        while True:
            k = rd_i32()
            if k == 0:
                break
            pos += k
        ucount = rd_i32()
    else:
        ucount = vn
    bcount = rd_i32()
    tcount = rd_i32()
    order = 3 if tcount else (2 if bcount else 1)
    counts = [ucount, bcount, tcount][:order]
    # unigrams (ucount + 1 incl. sentinel)
    uni = np.frombuffer(data, np.dtype([("mapid", en + "i4"),
                                        ("prob", en + "f4"),
                                        ("bo", en + "f4"),
                                        ("next", en + "i4")]),
                        ucount + 1, pos)
    pos += 16 * (ucount + 1)
    # bigrams (+ sentinel)
    bg = np.frombuffer(data, np.dtype([("wid", en + "u2"),
                                       ("p", en + "u2"),
                                       ("b", en + "u2"),
                                       ("next", en + "u2")]),
                       bcount + 1 if bcount else 0, pos)
    pos += 8 * len(bg)
    tg = np.frombuffer(data, np.dtype([("wid", en + "u2"),
                                       ("p", en + "u2")]),
                       tcount, pos)
    pos += 4 * tcount

    def read_table():
        nonlocal pos
        k = rd_i32()
        arr = np.frombuffer(data, en + "f4", k, pos).astype(np.float64)
        pos += 4 * k
        return arr * LOG10_TO_LOG

    levels: list[list] = [[] for _ in range(order)]
    for w in range(ucount):
        levels[0].append(((w,), float(uni["prob"][w]) * LOG10_TO_LOG,
                          float(uni["bo"][w]) * LOG10_TO_LOG))
    if order > 1:
        prob2 = read_table()
        bo2 = read_table() if order > 2 else np.zeros(0)
        prob3 = read_table() if order > 2 else np.zeros(0)
        # bigram parents from unigram next pointers
        unext = uni["next"].astype(np.int64)
        par = np.zeros(bcount, np.int64)
        for u in range(ucount):
            par[unext[u]:unext[u + 1]] = u
        for j in range(bcount):
            p = float(prob2[bg["p"][j]])
            b = float(bo2[bg["b"][j]]) if order > 2 else 0.0
            levels[1].append(((int(par[j]), int(bg["wid"][j])), p, b))
        if order > 2:
            k = rd_i32()
            tseg = np.frombuffer(data, en + "i4", k, pos).astype(np.int64)
            pos += 4 * k
            tnext = tseg[np.arange(bcount + 1) >> 9] \
                + bg["next"].astype(np.int64)
            tpar = np.zeros(tcount, np.int64)
            for j in range(bcount):
                tpar[tnext[j]:tnext[j + 1]] = j
            for i in range(tcount):
                j = int(tpar[i])
                ids = (int(par[j]), int(bg["wid"][j]), int(tg["wid"][i]))
                levels[2].append((ids, float(prob3[tg["p"][i]]), 0.0))
    # word strings
    k = rd_i32()
    words = [w.decode("utf-8", errors="replace")
             for w in data[pos:pos + k].split(b"\0")[:ucount]]
    return _assemble(order, counts, words, levels)


def read_trie_bin(path: str) -> NgramModel:
    """Decode the bit-packed *reverse* trie into forward-ordered levels.

    The trie stores n-gram (h_k .. h_1 w) along the path
    unigram[w] -> key h_1 -> key h_2 ... (KenLM-style suffix trie,
    src/lm/lm_trie.c:638-700: get_available_prob walks unigram_find(wid)
    then middle_find(hist[i]) with hist newest-first)."""
    with _open_maybe_compressed(path) as f:
        data = f.read()
    hdr = b"Trie Language Model"
    if not data.startswith(hdr):
        raise ValueError(f"{path}: not a trie LM binary")
    pos = len(hdr)
    order = data[pos]
    pos += 1
    counts = [int(c) for c in np.frombuffer(data, "<u4", order, pos)]
    pos += 4 * order
    V = counts[0]
    if order > 1:
        pos += 4  # quant type dummy
        nvalues = (order - 2) * (1 << 17) + (1 << 16)
        quant = np.frombuffer(data, "<f4", nvalues, pos).copy()
        pos += 4 * nvalues
    # unigrams (slot V is the end sentinel)
    uni = np.frombuffer(data, np.dtype([("prob", "<f4"), ("bo", "<f4"),
                                        ("next", "<u4")]), V + 1, pos)
    pos += 12 * (V + 1)
    word_bits = _required_bits(V)
    # decode each packed level: rev_words[l][k] = context key of entry k,
    # rev_next[l] = child ranges into level l+1
    rev = []
    for lvl in range(1, order):
        n = counts[lvl]
        is_longest = (lvl == order - 1)
        if is_longest:
            quant_bits = 16
            next_bits = 0
        else:
            quant_bits = 32
            next_bits = _required_bits(counts[lvl + 1])
        total_bits = word_bits + quant_bits + next_bits
        nbytes = ((1 + n) * total_bits + 7) // 8 + 8
        mem = np.frombuffer(data, np.uint8, nbytes, pos)
        mem = np.concatenate([mem, np.zeros(8, np.uint8)])
        pos += nbytes
        k = np.arange(n + 1, dtype=np.int64)     # incl. sentinel slot
        base_off = k * total_bits
        ws = _read_bits(mem, base_off[:n], word_bits)
        if is_longest:
            pidx = _read_bits(mem, base_off[:n] + word_bits, 16)
            probs = quant[(order - 2) * (1 << 17) + pidx]
            bos = np.zeros(n, np.float32)
            nxt = None
        else:
            # middle layout: [word][bo:16][prob:16][next]
            # (lm_trie_quant_mpread skips bo_bits before reading prob)
            bidx = _read_bits(mem, base_off[:n] + word_bits, 16)
            pidx = _read_bits(mem, base_off[:n] + word_bits + 16, 16)
            probs = quant[(lvl - 1) * (1 << 17) + pidx]
            bos = quant[(lvl - 1) * (1 << 17) + (1 << 16) + bidx]
            nxt = _read_bits(mem, base_off + word_bits + quant_bits,
                             next_bits)
        rev.append(dict(words=ws, prob=probs.astype(np.float32),
                        bo=bos.astype(np.float32), next=nxt))
    # word strings
    k = int(np.frombuffer(data, "<i4", 1, pos)[0])
    pos += 4
    words = [w.decode("utf-8", errors="replace")
             for w in data[pos:pos + k].split(b"\0")[:V]]

    # Reconstruct the forward n-grams from the reverse trie: entry k of
    # reverse level l is the n-gram (h_{l+1}, ..., h1, w), its key
    # h_{l+1} under the parent entry (h_l, ..., h1, w) of level l-1.
    levels = [(np.arange(V, dtype=np.int64)[:, None],
               uni["prob"][:V].astype(np.float32),
               uni["bo"][:V].astype(np.float32))]
    if order > 1:
        paths = np.arange(V, dtype=np.int64)[:, None]         # (w,)
        nxt = uni["next"].astype(np.int64)
        for lvl in range(1, order):
            n_par = len(paths)
            par = _range_owner(nxt, n_par, counts[lvl])
            paths = np.concatenate([rev[lvl - 1]["words"][:, None],
                                    paths[par]], axis=1)
            levels.append((paths, rev[lvl - 1]["prob"], rev[lvl - 1]["bo"]))
            nxt = rev[lvl - 1]["next"]
    return _assemble(order, counts, words, levels)


def _range_owner(nxt, n_par, n):
    """Owner of each of `n` children under the ordered CSR ranges
    nxt[k]:nxt[k+1] of `n_par` parents (children that no range covers
    belong to 0)."""
    par = np.zeros(n, np.int64)
    lo, hi = np.clip(nxt[:n_par], 0, n), np.clip(nxt[1:n_par + 1], 0, n)
    cnt = np.maximum(hi - lo, 0)
    par[np.repeat(lo, cnt) + np.arange(cnt.sum())
        - np.repeat(np.cumsum(cnt) - cnt, cnt)] = np.repeat(
            np.arange(n_par), cnt)
    return par
