"""The one traffic generator: it reads a mix (`traffic/<mix>.json`) and
the seed, and makes the utterances.

Every seed gets the same set of utterance lengths: the quantiles
(i + 1/2) / n of the mix's lognormal length distribution (its median and
sigma, clipped to its bounds and cut to whole 10 ms frames), in an order
and with PCM drawn from the seed.  So two seeds ask the same work of the
program, in another order and with other audio."""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

from ..inputs.synth import make_pcm

SAMPRATE = 16000


def lengths(spec: dict, n: int) -> list[float]:
    """n utterance lengths in seconds, ascending: the quantiles of a
    lognormal (`median_s`, `sigma`) clipped to [`min_s`, `max_s`]."""
    nd = NormalDist()
    out = []
    for i in range(n):
        x = spec["median_s"] * math.exp(spec["sigma"]
                                        * nd.inv_cdf((i + 0.5) / n))
        x = min(max(x, spec["min_s"]), spec["max_s"])
        out.append(round(x, 2))
    return out


def _rng(seed: int, *key: int):
    return np.random.default_rng([int(seed) % (1 << 63), *key])


def utterances(spec: dict, n: int, seed: int, key: int = 0) -> list:
    """n seeded int16 utterances of `lengths(spec, n)`, shuffled."""
    rng = _rng(seed, key)
    secs = lengths(spec, n)
    order = rng.permutation(n)
    pcm_seeds = rng.integers(0, 1 << 62, n)
    return [make_pcm(int(pcm_seeds[i]), secs[j]) for i, j in
            enumerate(order)]


def corpus_calls(mix: dict, seed: int) -> list:
    """The corpus mix's calls: `calls` lists of `utts_per_call` PCM
    utterances each (the window cycles through them)."""
    return [utterances(mix["length"], mix["utts_per_call"], seed, 1 + c)
            for c in range(mix["calls"])]


def stream_utterances(mix: dict, seed: int) -> list:
    """The stream mix's `utterances` (the window cycles through them)."""
    return utterances(mix["length"], mix["utterances"], seed, 0)


def sample(seed: int, n: int, k: int, key: int = 99) -> list[int]:
    """k distinct indices of range(n), drawn from the seed."""
    return sorted(int(i) for i in _rng(seed, key).choice(n, min(k, n),
                                                          replace=False))
