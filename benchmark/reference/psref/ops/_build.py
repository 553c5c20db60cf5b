"""The launch tallies of the port's `ops/_build.py`, without its
compiler and loader: the reference launches no kernel."""

from __future__ import annotations

import contextlib
import threading

_tallies = threading.local()


@contextlib.contextmanager
def tally():
    prev = getattr(_tallies, "counts", None)
    counts = _tallies.counts = {}
    try:
        yield counts
    finally:
        _tallies.counts = prev


def tallied(name: str) -> bool:
    counts = getattr(_tallies, "counts", None)
    if counts is None:
        return False
    counts[name] = counts.get(name, 0) + 1
    return True
