"""Deterministic WER evaluation corpus built from the reference's own
bundled speech (test/data/librivox + goforward).

The raw material on disk is ~75 transcribed words; a statistically
meaningful WER needs >= 1,000 scored words (the reference's own
regression corpus spirit, test/regression/test-main.sh).  Longer
utterances are therefore synthesized
by concatenating the base clips in seeded-shuffled orders with short
silence gaps; both decoders (this framework and the reference binary,
tools/make_wer20k_golden.py) decode the IDENTICAL synthesized audio, so
the comparison is exact even though base material repeats.

Everything is reproducible from the reference checkout alone: only the
reference binary's hypotheses (tests/golden/wer20k/ref.json) are
committed, not the audio.

A copy of `pocketsphinx_tpu.evalcorpus`.
"""

from __future__ import annotations

import glob
import os
import random

import numpy as np

from .fileio.sound import read_audio

GAP_S = 0.3      # silence between concatenated clips
SEED = 11
#: scored-word target for the committed evaluation corpus: >= 10k
#: reference words / >= 100 utterances; the
#: golden (tools/make_wer20k_golden.py) and bench.py must build the
#: corpus with the SAME target so hypotheses pair up by name.
TARGET_WORDS = 10500


def _base_clips(ref_dir: str):
    """[(name, pcm int16, ref_words)] for the transcribed bundled audio."""
    clips = []
    for p in sorted(glob.glob(os.path.join(
            ref_dir, "test/data/librivox/*.wav"))):
        pcm, sr = read_audio(p)
        assert sr == 16000
        words = open(p[:-4] + ".txt").read().split()
        name = os.path.basename(p)[:-4]
        clips.append((name, np.asarray(pcm, np.int16), words))
    pcm = np.frombuffer(
        open(os.path.join(ref_dir, "test/data/goforward.raw"), "rb").read(),
        dtype="<i2")
    clips.append(("goforward", pcm, "go forward ten meters".split()))
    return clips


def build_corpus(ref_dir: str, min_words: int = 1000, seed: int = SEED):
    """Deterministic corpus of >= min_words scored reference words.

    Returns [(name, pcm int16 array, ref_words list)].  The first
    entries are the 6 base clips; the rest are seeded concatenations of
    3-6 base clips separated by GAP_S of silence.
    """
    base = _base_clips(ref_dir)
    rng = random.Random(seed)
    gap = np.zeros(int(GAP_S * 16000), np.int16)
    corpus = list(base)
    n_words = sum(len(w) for _, _, w in base)
    i = 0
    while n_words < min_words:
        k = rng.randint(3, 6)
        picks = rng.sample(range(len(base)), k)
        parts, words = [], []
        for j in picks:
            parts.append(base[j][1])
            parts.append(gap)
            words += base[j][2]
        pcm = np.concatenate(parts[:-1])
        corpus.append((f"synth-{i:03d}", pcm, words))
        n_words += len(words)
        i += 1
    return corpus
