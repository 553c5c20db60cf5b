"""Word error rate scoring (the sphinxtrain word_align.pl contract:
WER = (substitutions + insertions + deletions) / reference length,
computed from a minimum-edit-distance alignment).

The reference repo ships no scorer (its regression compares full JSON
outputs); this module provides the corpus-WER metric demanded by the
BASELINE "equal WER to pocketsphinx_batch" contract.

A copy of `pocketsphinx_tpu.wer`."""

from __future__ import annotations


def align_words(ref: list[str], hyp: list[str]):
    """Minimum-edit-distance alignment.  Returns (n_corr, n_sub, n_ins,
    n_del, pairs) where pairs is [(ref_word | None, hyp_word | None)]
    (None marks an insertion/deletion slot)."""
    R, H = len(ref), len(hyp)
    # DP over (R+1) x (H+1); cost 1 for sub/ins/del
    INF = 1 << 30
    dist = [[0] * (H + 1) for _ in range(R + 1)]
    for i in range(1, R + 1):
        dist[i][0] = i
    for j in range(1, H + 1):
        dist[0][j] = j
    for i in range(1, R + 1):
        di, dim = dist[i], dist[i - 1]
        ri = ref[i - 1]
        for j in range(1, H + 1):
            sub = dim[j - 1] + (ri != hyp[j - 1])
            ins = di[j - 1] + 1
            dl = dim[j] + 1
            di[j] = sub if sub <= ins and sub <= dl else \
                (ins if ins <= dl else dl)
    # backtrace
    pairs = []
    i, j = R, H
    n_corr = n_sub = n_ins = n_del = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and \
                dist[i][j] == dist[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]):
            pairs.append((ref[i - 1], hyp[j - 1]))
            if ref[i - 1] == hyp[j - 1]:
                n_corr += 1
            else:
                n_sub += 1
            i -= 1
            j -= 1
        elif j > 0 and dist[i][j] == dist[i][j - 1] + 1:
            pairs.append((None, hyp[j - 1]))
            n_ins += 1
            j -= 1
        else:
            pairs.append((ref[i - 1], None))
            n_del += 1
            i -= 1
    pairs.reverse()
    return n_corr, n_sub, n_ins, n_del, pairs


def wer(refs: list[list[str]], hyps: list[list[str]]):
    """Corpus WER over parallel reference/hypothesis word lists.
    Returns dict(wer, n_ref, n_sub, n_ins, n_del, n_corr)."""
    tot = dict(n_ref=0, n_sub=0, n_ins=0, n_del=0, n_corr=0)
    for r, h in zip(refs, hyps):
        c, s, ins, dl, _ = align_words(list(r), list(h))
        tot["n_ref"] += len(r)
        tot["n_corr"] += c
        tot["n_sub"] += s
        tot["n_ins"] += ins
        tot["n_del"] += dl
    err = tot["n_sub"] + tot["n_ins"] + tot["n_del"]
    tot["wer"] = err / max(tot["n_ref"], 1)
    return tot
