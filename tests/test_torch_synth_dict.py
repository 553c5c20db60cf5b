"""`testing.synth.dictionary_for_lm`, which gives every word of an LM a
pronunciation for the 126k-word task: with bench-1.7k.dic as the base
dictionary and bench-20k.lm.bin's vocabulary, the dictionary is the same
for one seed and differs for another, covers every LM word once, keeps
the base words' own pronunciations, and needs no triphone that the base
dictionary does not (`make_model` over it writes a subset of the base
model's triphones)."""

import pytest

from pocketsphinx_tpu_torch.lm.ngram import read_lm
from pocketsphinx_tpu_torch.testing import synth

BASE = synth.BENCH_DATA / "bench-1.7k.dic"
LM = synth.BENCH_DATA / "bench-20k.lm.bin"


def _entries(path):
    return [ln.split(maxsplit=1) for ln in open(path).read().splitlines()]


@pytest.fixture(scope="module")
def dicts(tmp_path_factory):
    d = tmp_path_factory.mktemp("dict_for_lm")
    return [synth.dictionary_for_lm(str(LM), str(BASE), str(d / name),
                                    seed=seed)
            for name, seed in (("a.dic", 0), ("b.dic", 0), ("c.dic", 1))]


def test_deterministic_per_seed(dicts):
    a, b, c = (open(p).read() for p in dicts)
    assert a == b and a != c


def test_covers_every_lm_word(dicts):
    words = [w for w, _ in _entries(dicts[0])]
    lm_words = [w for w in read_lm(str(LM)).words if w not in ("<s>", "</s>")]
    assert words == lm_words and len(set(words)) == len(words)
    base = dict(reversed(_entries(BASE)))       # first pronunciation wins
    prons = set(base.values())
    kept = 0
    for w, p in _entries(dicts[0]):
        assert p in prons
        if w in base:
            assert p == base[w]
            kept += 1
    assert kept > 300


def test_no_new_triphones(dicts):
    rows = set(synth._triphones(synth.read_prons(dicts[0])))
    base = set(synth._triphones(synth.read_prons(str(BASE))))
    assert rows <= base and len(rows) > 0.9 * len(base)
