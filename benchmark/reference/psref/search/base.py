"""What the grammar, keyword, allphone and align searches share: a device,
tables there built from their host arrays, one utterance's senone costs
on it, and the per-frame scan of their step.

The JAX package runs each search's frames as one compiled `lax.scan`.
The counterpart here is `ChunkGraph`: CHUNK frames of the step over
static buffers, captured once as a CUDA graph and replayed for every
whole chunk, the last T mod CHUNK frames stepped eagerly by the same
step (a scan runs exactly T frames).  On the CPU the same chunk runs on
the same buffers without capture.  The n-gram scans share its capture
(`capture_chunk`) and its carry helpers."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import graph_capture
from ..models.acoustic import senone_scores
from ..ops import _build, chain, denoise, fan, transitions

#: frames per chunk of a captured scan
CHUNK = 16
#: the kernels' modules by name, whose `launches` counters a graph
#: replay adds to
KERNEL_OPS = {"chain": chain, "denoise": denoise, "fan": fan,
              "transitions": transitions}


def add_launches(made):
    """Add a capture's launches (kernel name -> launches, from
    `capture_chunk`) to the kernels' counters: what one replay
    launched."""
    for name, n in made.items():
        KERNEL_OPS[name].launches += n


def leaves(x):
    """The tensors of a carry: a tensor, or nested tuples of them."""
    if torch.is_tensor(x):
        return [x]
    return [leaf for y in x for leaf in leaves(y)]


def copy_tree(dst, src):
    """Copy carry `src` into the buffers of carry `dst` (same structure)."""
    for d, s in zip(leaves(dst), leaves(src)):
        d.copy_(s)


def clone_tree(x):
    """A carry in buffers of its own."""
    if torch.is_tensor(x):
        return x.clone()
    return tuple(clone_tree(y) for y in x)


def capture_chunk(device, chunk, pool=None, stream=None, before=None):
    """Capture `chunk()` (no arguments) as a CUDA graph on `device`: it
    runs once eagerly on a side stream first (each op's and kernel's
    first launch sets up what it needs there), then `before()` if given,
    then the capture, in the memory pool `pool` on `stream`
    (`graph_capture`).  The kernels' launches of the warm-up and of the
    capture count in this thread's `_build.tally` instead of their
    counters.  Returns (the graph, the capture's launches by kernel
    name), which a replay adds to the counters."""
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with _build.tally(), torch.cuda.stream(side):
            chunk()
        cur.wait_stream(side)
        if before is not None:
            before()
        graph = torch.cuda.CUDAGraph()
        with _build.tally() as made, graph_capture(graph, pool, stream):
            chunk()
    return graph, made


class ChunkGraph:
    """CHUNK frames of a search's step, `carry, records = step(carry,
    *(x[t] for x in xs), t)`, over static buffers: the carry, the chunk's
    inputs [CH, ...], the index of its first frame `t_base` (a 0-d int32
    tensor: each frame's index is `t_base + i`, so no record or carry of
    int32 is promoted) and the chunk's records [CH, ...].

    `key` names what the step reads besides its arguments (a search's
    device tables) and `shape` any shape it was made for: the search
    keeps the runner while both are the same (`fits`).  On a CUDA device
    the chunk is captured at the first `run`
    (`capture_chunk`; `capture_s` its seconds) and replayed for every
    whole chunk; on the CPU `run` calls the same chunk on the same
    buffers.  The step is passed in, not kept: the search keeps its
    runner, and a runner that kept the search would tie both into a
    cycle that only the garbage collector frees."""

    def __init__(self, device, key, shape=None):
        self.device, self.key, self.shape = torch.device(device), key, shape
        self.carry = self.xs = self.recs = None
        self.t_base = torch.zeros((), dtype=torch.int32, device=self.device)
        self.graph = None
        self.capture_s = 0.0

    def _chunk(self, step):
        carry = self.carry
        for i in range(CHUNK):
            carry, rec = step(carry, *(x[i] for x in self.xs),
                              self.t_base + i)
            if self.recs is None:
                self.recs = tuple(torch.empty((CHUNK,) + r.shape,
                                              dtype=r.dtype, device=r.device)
                                  for r in rec)
            for buf, r in zip(self.recs, rec):
                buf[i] = r
        copy_tree(self.carry, carry)

    def fits(self, key, shape=None):
        return self.key is key and self.shape == shape

    def _fresh_recs(self):
        self.recs = tuple(torch.empty_like(r) for r in self.recs)

    def run(self, step, carry, xs, T, t0=0):
        """Step `T` frames from `carry` over xs [T, ...], numbered from
        `t0`: the whole chunks through the graph (captured at the first
        call), the rest eagerly.  Returns (the records [T, ...] on the
        device, the carry after the last frame, which may be the static
        one)."""
        if self.carry is None:
            self.carry = clone_tree(carry)
            self.xs = tuple(torch.empty((CHUNK,) + x.shape[1:],
                                        dtype=x.dtype, device=x.device)
                            for x in xs)
        else:
            copy_tree(self.carry, carry)
        n_full = T // CHUNK * CHUNK
        out = None
        for c0 in range(0, n_full, CHUNK):
            for buf, x in zip(self.xs, xs):
                buf.copy_(x[c0:c0 + CHUNK])
            self.t_base.fill_(t0 + c0)
            if self.device.type != "cuda":
                self._chunk(step)
            else:
                if self.graph is None:
                    w0 = time.perf_counter()
                    self.graph, self.launches = capture_chunk(
                        self.device, lambda: self._chunk(step),
                        stream=torch.cuda.Stream(self.device),
                        before=self._fresh_recs)
                    copy_tree(self.carry, carry)   # the warm-up stepped it
                    self.capture_s = time.perf_counter() - w0
                self.graph.replay()
                add_launches(self.launches)
            if out is None:
                out = _records(self.recs, T)
            for o, r in zip(out, self.recs):
                o[c0:c0 + CHUNK] = r
        # the last T mod CHUNK frames, eagerly from the static carry
        carry = self.carry
        self.t_base.fill_(t0 + n_full)
        for t in range(n_full, T):
            carry, rec = step(carry, *(x[t] for x in xs),
                              self.t_base + (t - n_full))
            if out is None:
                out = _records([r[None] for r in rec], T)
            for o, r in zip(out, rec):
                o[t] = r
        return out, carry


def _records(chunk_recs, T):
    """Empty [T, ...] buffers for records shaped like `chunk_recs`
    [n, ...]."""
    return tuple(torch.empty((T,) + r.shape[1:], dtype=r.dtype,
                             device=r.device) for r in chunk_recs)


def host_to(device):
    """A function moving host arrays to `device` as tensors."""
    dev = torch.device(device)
    return lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)


class DeviceSearch:
    """A search whose per-frame step runs on `self.device` over the
    tensors `_device_tables(device)` makes from its host arrays (host
    code in subclasses stays the JAX package's).  Its frames run through
    a `ChunkGraph` (`graph` True, the default: captured at the first
    decode and kept while the tables are the same) or, with `graph`
    False, eagerly frame by frame (`_run`)."""

    device: torch.device
    graph: bool = False
    #: the search's `ChunkGraph` (None before its first decode)
    chunk_graph = None

    def _device_tables(self, device) -> dict:
        return {}

    def rebuild(self):
        """Rebuild the host network and the device tables after the
        dictionary changed (the JAX search's `_build`); the captured
        chunk goes with the old tables."""
        self._build()
        self.tables = self._device_tables(self.device)
        self.chunk_graph = None

    def to(self, device, graph=None):
        """A search sharing this one's host network, with its tables on
        `device` (e.g. to check a CUDA run against the CPU); `graph`
        (default this one's) as the constructor's."""
        other = object.__new__(type(self))
        other.__dict__.update(self.__dict__)
        other.device = torch.device(device)
        if graph is not None:
            other.graph = graph
        other.tables = self._device_tables(other.device)
        other.chunk_graph = None
        return other

    def utterance_costs(self, feats, costs=None):
        """One utterance's senone costs [T, n_sen] float32 on the device:
        `costs` as given, else scored from feats [T, F, L]."""
        if costs is None:
            x = torch.as_tensor(np.asarray(feats, np.float32)[None],
                                device=self.device)
            costs = senone_scores(self.am.scoring_tensors(self.device), x)[0]
        return torch.as_tensor(costs, device=self.device).to(torch.float32)

    def _scan(self, step, carry, xs, T, key=None):
        """Step `T` frames of xs [T, ...] from `carry` (`step` as in
        `ChunkGraph`): through the search's `ChunkGraph` for `key`
        (default its device tables; made anew when the key changes), or
        eagerly when `graph` is False.  Returns (the records [T, ...] on
        the device, their host copies): one copy per utterance, not a
        sync per frame."""
        if not self.graph:
            return self._run(step, carry, xs, T)
        key = self.tables if key is None else key
        run = self.chunk_graph
        if run is None or not run.fits(key):
            run = self.chunk_graph = ChunkGraph(self.device, key)
        recs = run.run(step, carry, xs, T)[0]
        return recs, tuple(r.cpu().numpy() for r in recs)

    @staticmethod
    def _run(step, carry, xs, T):
        """Step `T` frames eagerly, one Python call of `step` per frame,
        the frame index a Python int, writing each frame's records into
        [T, ...] buffers on the device (made at the first frame).
        Returns (the buffers, their host copies)."""
        recs = None
        for t in range(T):
            carry, rec = step(carry, *(x[t] for x in xs), t)
            if recs is None:
                recs = tuple(torch.empty((T,) + r.shape, dtype=r.dtype,
                                         device=r.device) for r in rec)
            for buf, r in zip(recs, rec):
                buf[t] = r
        return recs, tuple(r.cpu().numpy() for r in recs)
