"""Data- and tensor-parallel corpus decoding on torch devices.

Port of `pocketsphinx_tpu.parallel.batch`.  The reference has no
parallelism (its scale is many processes over a -ctl split); here a
corpus is decoded in padded batches, and each batch is split over a
`Mesh` of devices along its "data" axis, each row of the mesh holding a
replica of the search and decoding its utterances in a host thread of
its own.  Decoding is embarrassingly parallel over utterances: a row's
result does not depend on the rows beside it.

Along the "model" axis a row's devices share one replica (tensor
parallelism, `NgramFusedDecoder.shard`): the row's first device, its
lead, steps the search, and every device of the row runs the
word-transition block over its range of the LM tables' entry columns
and scores its share of the codebooks or senone slots.  Cross-device
traffic is peer copies ordered by the devices' current streams, in one
process; two parts on one device (`Mesh([["cuda:0", "cuda:0"]])`) check
the split on one card.

Multi-process: `init_distributed` starts a `torch.distributed` process
group (gloo), `shard_ctl` splits the control file by process rank,
each process decodes its shard over its local mesh, and
`global_metric_sum` reduces corpus metrics (utterance, frame, error
counts) across processes with an all-reduce of a CPU tensor over gloo,
as the JAX package reduces on its CPU backend.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import on_device, profile, resolve_device
from ..frontend.feat import batch_features

def _rank_count():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Start the process group (gloo).  Pass the coordinator
    ("host:port"), the process count and this process's rank; without a
    coordinator they come from the environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK).  Returns (rank, world size)."""
    import torch.distributed as dist
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(
        "gloo", init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    return dist.get_rank(), dist.get_world_size()


def shard_ctl(entries: list, process_id: int | None = None,
              process_count: int | None = None) -> list:
    """Shard a -ctl utterance list across processes (strided, so
    length-sorted corpora balance).  Defaults to the live process
    group's rank and size (0 and 1 without one)."""
    rank, n = _rank_count()
    pid = rank if process_id is None else process_id
    n = n if process_count is None else process_count
    return entries[pid::n]


def global_metric_sum(local_vector) -> np.ndarray:
    """Sum a per-process float32 metric vector across all processes of
    the process group (`init_distributed`'s, gloo): an all-reduce of a
    CPU tensor.  Single-process: returns the input unchanged."""
    import torch.distributed as dist
    local = np.asarray(local_vector, np.float32).reshape(-1)
    if _rank_count()[1] == 1:
        return local
    t = torch.from_numpy(local.copy())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


class Mesh:
    """A [n_data, n_model] grid of torch devices (the JAX
    `jax.sharding.Mesh` with axes ("data", "model"))."""

    def __init__(self, devices):
        self.devices = np.empty(np.shape(devices)[:2], dtype=object)
        for i, row in enumerate(devices):
            for j, d in enumerate(row):
                self.devices[i, j] = torch.device(d)

    @property
    def shape(self) -> dict:
        return {"data": self.devices.shape[0],
                "model": self.devices.shape[1]}


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None):
    """A ("data", "model") mesh of [n_data, n_model] devices: the first
    n_data * n_model CUDA cards, row by row (CUDA unless `device` says
    otherwise; n_data defaults to every card over n_model), or as many
    entries of the CPU (n_data default 1)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        n_data = len(cards) // n_model if n_data is None else n_data
        if n_data * n_model > len(cards) or n_data < 1:
            raise ValueError(f"{n_data} data replicas x {n_model} model "
                             f"shards but {len(cards)} CUDA devices")
        devs = cards[:n_data * n_model]
    else:
        devs = [dev] * ((1 if n_data is None else n_data) * n_model)
    return Mesh([devs[i:i + n_model] for i in range(0, len(devs), n_model)])


def _same(a: torch.device, b: torch.device) -> bool:
    return resolve_device(a) == resolve_device(b)


def replicas(search, rows) -> list:
    """One search per row of a mesh's devices: with one device per row,
    `search` itself on the first device it already lives on and
    `search.to(device)` on every other; with a "model" axis,
    `search.shard(row)`."""
    out, used = [], False
    for row in rows:
        if len(row) > 1:
            out.append(search.shard(list(row)))
        elif not used and _same(row[0], search.device):
            out.append(search)
            used = True
        else:
            out.append(search.to(row[0]))
    return out


class BatchDecodePipeline:
    """Corpus decoding over a mesh's data axis, and its model axis.

    Wraps a search with `decode_batch` (`NgramFusedDecoder`) and the
    frontend: each batch of padded utterances is split over the mesh's
    rows, and each row runs PCM -> MFCC -> features -> senone scores ->
    the batched scan -> the backtrace on its utterances, on its lead
    device, with the scoring and the scan's word-transition block split
    over the row's devices when the mesh has a "model" axis."""

    def __init__(self, decoder_search, frontend, mesh=None,
                 cmn: str = "batch"):
        self.search = decoder_search
        self.fe = frontend
        self.mesh = mesh or make_mesh(device=decoder_search.device)
        self.cmn = cmn
        #: the batched features of the model's `feat.params` (-feat,
        #: -svspec); CMN is `cmn` ("batch": each utterance's mean)
        fp = decoder_search.am.feat_params
        self.features = batch_features(fp["feat"], fp["svspec"])
        self.replicas = replicas(decoder_search, self.mesh.devices)
        #: guard violations summed over the last `decode_corpus`
        self.guard_violations = 0

    @property
    def data_parallelism(self) -> int:
        return self.mesh.shape["data"]

    def decode_corpus(self, pcm_list: list[np.ndarray],
                      batch_size: int | None = None, timings=None):
        """Decode a list of PCM utterances; returns [(hyp, segs)] in input
        order.

        Utterances are sorted by length and decoded in batches of
        `batch_size` (default 8 per row of the mesh), each padded to its
        longest utterance and split over the mesh's data axis.  With more
        than one replica, each replica's rows run in a host thread of
        their own with its (lead) device current, so the replicas' work
        overlaps; the batch ends when every replica has backtraced its
        rows.  The scan
        keeps the minimal (top-K) records: their backtrace is the 1-best
        walk of the full records (every path predecessor is a top-K exit).
        A dict passed as `timings` receives the seconds of each stage
        (frontend, scoring, scan, backtrace) summed over the batches and
        the replicas (the devices are synchronized at each stage
        boundary).  The stages are `profile` spans ("ps.corpus",
        "ps.batch", "ps.frontend" and the search's)."""
        with profile.span("ps.corpus"):
            dp = self.data_parallelism
            B = batch_size or 8 * dp
            B = (B // dp) * dp or dp
            order = sorted(range(len(pcm_list)),
                           key=lambda i: len(pcm_list[i]))
            results: list = [None] * len(pcm_list)
            self.guard_violations = 0

            def run(part):
                return self._decode_rows(pcm_list, *part,
                                         timings is not None)

            pool = ThreadPoolExecutor(dp) if dp > 1 else None
            try:
                for i0 in range(0, len(order), B):
                    parts = [(rows, search) for rows, search in zip(
                        np.array_split(np.array(order[i0:i0 + B]), dp),
                        self.replicas) if len(rows)]
                    outs = (list(pool.map(run, parts)) if pool
                            else [run(p) for p in parts])
                    for (rows, search), (out, st) in zip(parts, outs):
                        for k, v in (st or {}).items():
                            timings[k] = timings.get(k, 0.0) + v
                        self.guard_violations += search.guard_violations
                        for k, i in enumerate(rows):
                            results[i] = out[k]
            finally:
                if pool is not None:
                    pool.shutdown()
            return results

    def _decode_rows(self, pcm_list, rows, search, timed: bool):
        """PCM -> (hyp, segs) of the utterances `rows` through `search`, on
        its device -> (results, stage seconds or None).  The features are
        those of the model's feature type (`batch_features`)."""

        dev = search.device
        st = {} if timed else None
        with on_device(dev), profile.span("ps.batch"):
            with profile.span("ps.frontend", st, "frontend", dev):
                with profile.span("ps.frontend.pcm"):
                    pcm = np.zeros((len(rows),
                                    max(len(pcm_list[i]) for i in rows)),
                                   np.float32)
                    for k, i in enumerate(rows):
                        pcm[k, :len(pcm_list[i])] = pcm_list[i]
                    ns = np.array([len(pcm_list[i]) for i in rows], np.int32)
                with profile.span("ps.frontend.mfcc"):
                    cep, nfr = self.fe.process_batch(pcm, ns, device=dev)
                with profile.span("ps.frontend.features"):
                    feats = self.features(cep, nfr, cmn=self.cmn)
            out = search.decode_batch(feats, nfr, keep_records=False,
                                      timings=st)
        return out, st
