"""Write `psref/`, the plain reference, from a tree of the port.

`psref` is a frozen copy of the modules of `pocketsphinx_tpu_torch` that
the benchmark's two entry points run (the n-gram search, its tables, the
frontend, the scoring, the `Decoder` facade and the best-path lattice),
with every hand-written kernel taken out: each kernel wrapper calls its
plain PyTorch version on every device, nothing loads a compiled library,
every search steps eagerly (no CUDA graph), and the mode searches that
no cell runs are left out.  The port's CPU tests hold those plain
versions bit for bit to the JAX package, so the copy carries that
package's semantics into a process that may import neither.

    python benchmark/reference/freeze.py SRC [OUT]

SRC is the port's package directory of the tree to freeze from; OUT
defaults to `psref` beside this file.  The copy's package docstring
names the commit it came from.  The harness never runs this script.
"""

from __future__ import annotations

import ast
import re
import shutil
import sys
from pathlib import Path

#: the modules copied, by path under the package
MODULES = (
    "__init__.py", "config.py", "convert.py", "decoder.py", "err.py",
    "logmath.py", "profile.py",
    "fileio/__init__.py", "fileio/acoustic.py", "fileio/bin_mdef.py",
    "fileio/dictionary.py", "fileio/mfc.py", "fileio/s3.py",
    "frontend/__init__.py", "frontend/feat.py", "frontend/mfcc.py",
    "frontend/stream.py",
    "lm/__init__.py", "lm/ngram.py",
    "models/__init__.py", "models/acoustic.py", "models/dict2pid.py",
    "ops/__init__.py", "ops/chain.py", "ops/denoise.py", "ops/fan.py",
    "ops/hmm.py", "ops/transitions.py",
    "search/__init__.py", "search/align.py", "search/base.py",
    "search/lattice.py", "search/ngram_fused.py",
)

#: kernel wrapper -> (its module, the plain body that replaces it)
PLAIN = {
    "fan_step": ("ops/fan.py", '''
def fan_step(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f=None,
             groups=None):
    """`fan_step_ref` on every device (the reference runs no kernel)."""
    _check(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f)
    return fan_step_ref(S, TF, CX, pred, ptf, pcx, pre, lp, tp, out_f)
'''),
    "chain_group_step": ("ops/chain.py", '''
def chain_group_step(grp, S, TF, CTX, VAR, g, pip):
    """`chain_group_ref` on every device (the reference runs no
    kernel)."""
    if VAR is None:
        VAR = torch.zeros(0, dtype=torch.int32, device=S.device)
    _check_group(grp, S, TF, CTX, VAR, g)
    return chain_group_ref(grp, S, TF, CTX, VAR, g, pip)
'''),
    "transitions": ("ops/transitions.py", '''
def transitions(tb, lm, kv, ki, ctx_k, fb_k, svk, wpen,
                cols_per_thread=None, k_split=None, out=None):
    """`transitions_ref` on every device (the reference runs no
    kernel)."""
    _check_exits(kv, ki, ctx_k, fb_k, svk)
    return transitions_ref(tb, lm, kv, ki, ctx_k, fb_k, svk, wpen, out)
'''),
    "gains": ("ops/denoise.py", '''
def gains(mfspec):
    """`gains_ref` on every device (the reference runs no kernel)."""
    _check(mfspec)
    return gains_ref(mfspec)
'''),
    "graph_capture": ("__init__.py", '''
def graph_capture(graph, pool=None, stream=None):
    """The reference steps every search eagerly and captures nothing."""
    raise RuntimeError("psref captures no CUDA graph")
'''),
}

#: what stands for `ops/_build.py`: the launch tallies, and no loader
BUILD_STUB = '''"""The launch tallies of the port's `ops/_build.py`, without its
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
'''


def replace_def(text: str, name: str, new: str) -> str:
    """`text` with the top-level function `name` replaced by `new`."""
    tree = ast.parse(text)
    lines = text.splitlines(keepends=True)
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            start = min([node.lineno] + [d.lineno for d in
                                         node.decorator_list]) - 1
            return "".join(lines[:start]) + new.lstrip("\n") + "".join(
                lines[node.end_lineno:])
    raise KeyError(f"no top-level function {name}")


def drop_def(text: str, name: str) -> str:
    try:
        return replace_def(text, name, "")
    except KeyError:
        return text


def freeze(src: Path, out: Path, commit: str = "unknown"):
    if out.exists():
        shutil.rmtree(out)
    for rel in MODULES:
        dst = out / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        text = (src / rel).read_text()
        for name, (mod, body) in PLAIN.items():
            if mod == rel:
                text = replace_def(text, name, body)
        if rel.startswith("ops/"):
            text = drop_def(text, "_lib")
        # every search steps eagerly unless told otherwise
        text = text.replace("graph: bool = True", "graph: bool = False")
        dst.write_text(text)
    (out / "ops" / "_build.py").write_text(BUILD_STUB)
    init = out / "__init__.py"
    text = init.read_text()
    doc = (f'"""psref: a frozen copy of pocketsphinx_tpu_torch (commit '
           f'{commit}) with the\nkernels taken out; written by '
           f'benchmark/reference/freeze.py.\n\n')
    init.write_text(re.sub(r'^"""', doc, text, count=1))


if __name__ == "__main__":
    src = Path(sys.argv[1])
    out = Path(sys.argv[2]) if len(sys.argv) > 2 else \
        Path(__file__).resolve().parent / "psref"
    commit = sys.argv[3] if len(sys.argv) > 3 else "unknown"
    freeze(src, out, commit)
