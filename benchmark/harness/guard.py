"""The import guard: no JAX, and not the JAX package, in the process that
reports.  Names are compared whole, by their top-level part (before the
first dot), so `pocketsphinx_tpu_torch` is not `pocketsphinx_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pocketsphinx_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
