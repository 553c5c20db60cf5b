"""The scan runner every search steps through (`ChunkGraph`), and what the
grammar, keyword, allphone and align searches share: a device, tables
there built from their host arrays, one utterance's senone costs on it.

The JAX package runs each search's frames as one compiled `lax.scan`.
The counterpart here is `ChunkGraph`, the one runner of the fused and
flat n-gram scans and of the grammar, keyword, allphone and align
searches: CHUNK frames of a search's steps over static buffers, captured
once as a CUDA graph and replayed for every whole chunk, the last T mod
CHUNK frames stepped eagerly by the same steps (a scan runs exactly T
frames; the n-gram scans pad T to whole chunks).  On the CPU, and with
`graph=False`, the same chunk runs on the same buffers without capture."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import graph_capture, profile
from ..models.acoustic import senone_scores
from ..ops import _build

#: frames per chunk of a scan
CHUNK = 16


def copy_tree(dst, src):
    """Copy carry `src` into the buffers of carry `dst` (same structure: a
    tensor, or nested tuples or dicts of them, None for an empty
    part)."""
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, d in dst.items():
            copy_tree(d, src[k])
    elif dst is not None:
        for d, s in zip(dst, src, strict=True):
            copy_tree(d, s)


def clone_tree(x):
    """A carry (as `copy_tree`'s) in buffers of its own."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return None if x is None else tuple(clone_tree(y) for y in x)


def frames(step, axis=0):
    """A per-frame step, `carry, records = step(carry, *x_t, t)`, as the
    steps of a chunk (`ChunkGraph.run`): frame i of the chunk's inputs
    (along `axis`) in turn, its index `t_base + i`."""
    def steps(carry, xs, t_base):
        for i in range(xs[0].shape[axis]):
            carry, rec = step(carry, *(x.select(axis, i) for x in xs),
                              t_base + i)
            yield i, carry, rec
    return steps


def _records(rec, n, axis):
    """Empty buffers of `n` frames (along `axis`) for records shaped like
    one frame's `rec`."""
    return tuple(torch.empty(r.shape[:axis] + (n,) + r.shape[axis:],
                             dtype=r.dtype, device=r.device) for r in rec)


class ChunkGraph:
    """The runner of a search's scan: CHUNK frames of its steps over
    static buffers of one shape -- the carry, the chunk's inputs (CHUNK
    frames along the time axis `axis`: 0 for the mode searches' [T, ...]
    inputs and records, 1 for the n-gram scans' batch-major [B, T, ...]),
    the index of its first frame `t_base` (a 0-d int32 tensor: frame i
    is `t_base + i`, so no int32 record or carry is promoted) and the
    chunk's records of each record kind.

    `key` names what the steps read besides their arguments (a search's
    device tables) and `shape` any shape it was made for: the search
    keeps the runner while both are the same (`fits`), and drops it, its
    buffers and graphs with it, otherwise.  `carry` is the static carry
    (None: a copy of the first `run`'s).  The record kinds (`variant`:
    the fused n-gram scan's (minimal, mask)) share the static inputs and
    carry, one memory pool and one capture stream, as their replays
    never overlap; `held` keeps what else their captures write (a split
    decoder's block buffers).

    On a CUDA device a kind's chunk is captured at its first `run` with
    `capture` (`capture_s`: the seconds of the captures) and replayed for
    every whole chunk; otherwise `run` calls the same chunk on the same
    buffers.  The kernels' launches of the warm-up and of the capture
    count in the capturing thread's `_build.tally` instead (they step no
    frame, and another replica's thread may launch meanwhile), and each
    replay adds the capture's to `_build.launches`.  Each chunk is a
    "ps.scan.chunk" span, the eager rest a "ps.scan.tail" one.  The
    steps and the carry's reset are passed in, not kept: the search keeps
    its runner, and a runner that kept the search would tie both into a
    cycle that only the garbage collector frees."""

    def __init__(self, device, key, shape=None, carry=None, axis=0):
        self.device, self.key, self.shape = torch.device(device), key, shape
        self.carry, self.axis = carry, axis
        self.xs = None
        self.t_base = torch.zeros((), dtype=torch.int32, device=self.device)
        #: each record kind's chunk records, and its (graph, launches)
        self.recs, self.graphs = {}, {}
        self.held = self.pool = self.stream = None
        self.capture_s = 0.0

    def fits(self, key, shape=None):
        return self.key is key and self.shape == shape

    def _chunk(self, steps, variant):
        """One chunk of `steps` from the static carry, into it."""
        recs = self.recs.get(variant)
        for i, carry, rec in steps(self.carry, self.xs, self.t_base):
            if recs is None:
                recs = self.recs[variant] = _records(rec, CHUNK, self.axis)
            for buf, r in zip(recs, rec):
                buf.select(self.axis, i).copy_(r)
        copy_tree(self.carry, carry)

    def _capture(self, steps, variant):
        """Capture the chunk of record kind `variant` as a CUDA graph: it
        runs once eagerly on a side stream first (each op's and kernel's
        first launch sets up what it needs there), then the capture on
        the runner's stream into its pool (`graph_capture`), into fresh
        records.  A split decoder's chunk holds every part's block: the
        warm-up runs each part once on its card, and the capture takes in
        the streams of the parts on other cards, so that a replay steps
        the whole group.  Nothing here syncs a card outside the capture
        lock: another replica's thread may be capturing on the same card,
        and a device-wide sync invalidates its capture.  Returns (the
        graph, its launches by kernel name)."""
        w0, b0 = time.perf_counter(), _build.seconds
        with profile.span("ps.capture"), torch.cuda.device(self.device):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
                self.stream = torch.cuda.Stream()
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with _build.tally(), torch.cuda.stream(side):
                self._chunk(steps, variant)
            cur.wait_stream(side)
            self.recs[variant] = tuple(torch.empty_like(r)
                                       for r in self.recs[variant])
            graph = torch.cuda.CUDAGraph()
            with _build.tally() as made, graph_capture(graph, self.pool,
                                                       self.stream):
                self._chunk(steps, variant)
        # the seconds without the kernels' builds inside them
        secs = time.perf_counter() - w0 - (_build.seconds - b0)
        profile.count("capture_s", secs)
        self.capture_s += secs
        self.graphs[variant] = graph, made
        return graph, made

    def run(self, steps, carry, xs, T, t0=0, variant=None, capture=True,
            reset=None):
        """Step `T` frames of the inputs xs (along the time axis), numbered
        from `t0`, from `carry` (None: the static carry as `reset` sets
        it).  `steps(carry, xs, t_base)` steps the frames of its inputs
        from `carry`, yielding (frame, carry after it, its records) for
        each (`frames` makes it of a per-frame step).  The whole chunks
        run from the static carry, replayed with `capture` on a CUDA
        device, else called; the rest eagerly.  Returns (the records, T
        frames along the time axis on the device; the carry after the
        last frame, which may be the static one)."""
        ax = self.axis
        if self.xs is None:         # zeros: a capture's warm-up reads them
            self.xs = tuple(torch.zeros(x.shape[:ax] + (CHUNK,)
                                        + x.shape[ax + 1:], dtype=x.dtype,
                                        device=x.device) for x in xs)
        if self.carry is None:
            self.carry = clone_tree(carry)
        n_full = T // CHUNK * CHUNK
        graph = None
        if n_full and capture and self.device.type == "cuda":
            graph = (self.graphs.get(variant)
                     or self._capture(steps, variant))
        # after any capture, whose warm-up stepped the static carry
        if carry is None:
            reset(self.carry)
        else:
            copy_tree(self.carry, carry)
        out = None
        for c0 in range(0, n_full, CHUNK):
            with profile.span("ps.scan.chunk"):
                for buf, x in zip(self.xs, xs):
                    buf.copy_(x.narrow(ax, c0, CHUNK))
                self.t_base.fill_(t0 + c0)
                if graph is None:
                    self._chunk(steps, variant)
                else:
                    graph[0].replay()
                    _build.add_launches(graph[1])
                recs = self.recs[variant]
                if out is None:
                    out = _records([r.select(ax, 0) for r in recs], T, ax)
                for o, r in zip(out, recs):
                    o.narrow(ax, c0, CHUNK).copy_(r)
        carry = self.carry
        if T > n_full:
            self.t_base.fill_(t0 + n_full)
            with profile.span("ps.scan.tail"):
                for i, carry, rec in steps(
                        carry, tuple(x.narrow(ax, n_full, T - n_full)
                                     for x in xs), self.t_base):
                    if out is None:
                        out = _records(rec, T, ax)
                    for o, r in zip(out, rec):
                        o.select(ax, n_full + i).copy_(r)
        return out, carry


def host_to(device):
    """A function moving host arrays to `device` as tensors."""
    dev = torch.device(device)
    return lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)


class DeviceSearch:
    """A search whose per-frame step runs on `self.device` over the
    tensors `_device_tables(device)` makes from its host arrays (host
    code in subclasses stays the JAX package's).  Its frames run through
    a `ChunkGraph`, kept while the tables are the same, whose chunk is
    captured at the first decode (`graph` True, the default) or, with
    `graph` False, called."""

    device: torch.device
    graph: bool = True
    #: the search's `ChunkGraph` (None before its first decode)
    chunk_graph = None

    def _device_tables(self, device) -> dict:
        return {}

    def rebuild(self):
        """Rebuild the host network and the device tables after the
        dictionary changed (the JAX search's `_build`); the runner goes
        with the old tables."""
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
        """Step `T` frames of xs [T, ...] from `carry` with the per-frame
        `step` (`frames`) through the search's `ChunkGraph` for `key`
        (default its device tables; made anew when the key changes).
        Returns (the records [T, ...] on the device, their host copies):
        one copy per utterance, not a sync per frame."""
        key = self.tables if key is None else key
        run = self.chunk_graph
        if run is None or not run.fits(key):
            run = self.chunk_graph = ChunkGraph(self.device, key)
        recs = run.run(frames(step), carry, xs, T, capture=self.graph)[0]
        return recs, tuple(r.cpu().numpy() for r in recs)
