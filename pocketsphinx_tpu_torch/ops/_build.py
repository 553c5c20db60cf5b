"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on
first use into `build/torch_kernels/lib<name>-<hash>.so` at the root of
the checkout (the hash is of the source, so an edited source rebuilds).
The build directory is listed in `.gitignore`; nothing here runs at
import time.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         --fmad=false -shared -Xcompiler -fPIC

`--fmad=false` is part of the exactness contract: the kernels must be
bit-equal to the JAX records, and contracting an add chain with a
multiply into an FMA changes bits.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: nvcc's output of each kernel's last build in this process (with
#: `verbose`, `-Xptxas -v`'s registers, shared memory and spills)
logs: dict[str, str] = {}
#: the open `tally` of each thread
_tallies = threading.local()
#: the launches of each kernel in this process (kernel name -> count):
#: the wrappers' own (`launched`) and what CUDA-graph replays add
#: (`add_launches`)
launches: dict[str, int] = {}
_count_lock = threading.Lock()
#: the wall seconds of this process's kernel builds
seconds = 0.0


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin)")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names, verbose: bool = False) -> dict[str, float]:
    """Compile the named kernels that are not built yet, one nvcc
    process per source, all started together.  Returns the seconds each
    build took (0.0 for one already on disk), and adds the wall seconds
    of the builds to `seconds`.  Raises with nvcc's output when a build
    fails."""
    import time
    global seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        logs[name] = log
        if p.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log:
            print(log, flush=True)
        os.replace(tmp, out)
    if procs:
        seconds += time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


@contextlib.contextmanager
def tally():
    """Count the kernel launches this thread makes inside the block in
    the dict it yields (kernel name -> launches) instead of `launches`:
    what a CUDA-graph capture records (each replay adds it to `launches`)
    and its warm-up, apart from the launches any other thread makes
    meanwhile."""
    prev = getattr(_tallies, "counts", None)
    counts = _tallies.counts = {}
    try:
        yield counts
    finally:
        _tallies.counts = prev


def launched(name: str):
    """Count one launch of kernel `name`: in this thread's open `tally`,
    else in `launches`."""
    counts = getattr(_tallies, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1
    else:
        add_launches({name: 1})


def add_launches(made):
    """Add launches by kernel name (a capture's `tally`: what one replay
    of its graph launched) to `launches`."""
    with _count_lock:
        for name, n in made.items():
            launches[name] = launches.get(name, 0) + n
