"""The traffic generator: the same seed gives the same utterances, and
every seed the same set of lengths in another order."""

import json

import numpy as np

from benchmark.harness import traffic
from benchmark.harness.cells import BENCH

BATCH = json.loads((BENCH / "traffic" / "batch.json").read_text())
STREAM = json.loads((BENCH / "traffic" / "stream.json").read_text())


def test_lengths_are_the_quantiles():
    xs = traffic.lengths(BATCH["length"], 16)
    assert xs == sorted(xs) and len(xs) == 16
    assert abs(xs[7] * xs[8] - 36.0) < 0.5        # around the 6 s median
    assert 1.0 <= xs[0] and xs[-1] <= 20.0
    ys = traffic.lengths(STREAM["length"], 16)
    assert ys[0] == 1.0 and ys[-1] <= 8.0          # the low tail clipped


def test_same_seed_same_utterances():
    big = 2 ** 31 + 12345
    a = traffic.stream_utterances(STREAM, big)
    b = traffic.stream_utterances(STREAM, big)
    assert len(a) == STREAM["utterances"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_other_seed_same_lengths_other_order():
    a = traffic.stream_utterances(STREAM, 11)
    b = traffic.stream_utterances(STREAM, 12)
    la, lb = [len(x) for x in a], [len(x) for x in b]
    assert sorted(la) == sorted(lb)
    assert la != lb
    assert not np.array_equal(a[0][:1000], b[0][:1000])


def test_corpus_calls():
    mix = dict(BATCH, length={"median_s": 1.2, "sigma": 0.3, "min_s": 1.0,
                              "max_s": 2.0})
    calls = traffic.corpus_calls(mix, 5)
    assert len(calls) == mix["calls"]
    assert all(len(c) == mix["utts_per_call"] for c in calls)
    assert sorted(map(len, calls[0])) == sorted(map(len, calls[1]))
    assert all(x.dtype == np.int16 for c in calls for x in c)


def test_sample_is_seeded():
    assert traffic.sample(7, 16, 3) == traffic.sample(7, 16, 3)
    assert len(set(traffic.sample(7, 16, 3))) == 3
    assert traffic.sample(7, 2, 5) == [0, 1]
