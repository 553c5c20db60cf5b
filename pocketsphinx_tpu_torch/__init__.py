"""pocketsphinx-tpu-torch: the recognizer's main path in PyTorch and CUDA.

A port of `pocketsphinx_tpu` (JAX) to PyTorch on NVIDIA Hopper.  The
layout mirrors the JAX package: each module sits at the same relative
path as its counterpart.  Host-side model and LM loading are NumPy
copies; device compute is torch, and the two per-frame search blocks
that the JAX package wrote as Pallas kernels are hand-written CUDA
kernels (`csrc/`, bound in `ops/`).

The user's entry point is `Decoder` (with `Config`, `Hypothesis`,
`Segment`), loaded lazily on first access.  Entry points run on CUDA
unless the caller passes `device="cpu"`; they raise when CUDA is absent
and the CPU was not asked for.  Float32
matrix products run at full precision (no TF32), as the JAX package
scores at `Precision.HIGHEST`.
"""

import contextlib
import gc
import threading

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` says
    otherwise.  A CUDA device without an index is the current card
    (`torch.cuda.current_device()`), so a search built on it stays on that
    card whatever card is current later.  Raises when CUDA was implied but
    is not available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(device):
    """A context in which `device` is the current CUDA card (the card its
    ops launch and allocate on when they do not name one); a no-op off
    CUDA."""
    device = torch.device(device)
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


#: held through every capture of `graph_capture`, one at a time
_capture_lock = threading.Lock()


@contextlib.contextmanager
def graph_capture(graph, pool=None, stream=None):
    """`torch.cuda.graph(graph, pool, stream)` on the current card, with
    what a capture forbids checked in the capturing thread only
    ("thread_local": another replica's thread may sync its own card
    meanwhile) and Python's garbage collector stopped: collecting an
    unreachable CUDA graph during a capture destroys it, a call that
    invalidates the capture (torch does not collect before a capture).
    Captures in the process run one at a time, so that the collector is
    on again only after the last one.  Pass a `stream` of the current
    card where it may not be the first card captured on: torch's own
    default capture stream is one for the process, on the card current
    at its first capture.

    The graph takes in the work of streams on other cards that wait on
    an event recorded in the capture and that the capture waits on
    again before it ends (a decoder split over a "model" group): one
    graph over the group's cards.  Only the current card's allocations
    go to the graph's pool, so such work must allocate nothing."""
    with _capture_lock:
        collect = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool,
                                  stream=stream,
                                  capture_error_mode="thread_local"):
                yield
        finally:
            if collect:
                gc.enable()


def __getattr__(name):
    """Lazy top-level API (the JAX package's exports): the decoder's
    modules load on first access, not at package import."""
    if name in ("Decoder", "Config", "Hypothesis", "Segment"):
        from . import decoder as _d
        from .config import Config as _C
        return {"Decoder": _d.Decoder, "Config": _C,
                "Hypothesis": _d.Hypothesis, "Segment": _d.Segment}[name]
    if name == "err":
        import importlib
        return importlib.import_module(".err", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
