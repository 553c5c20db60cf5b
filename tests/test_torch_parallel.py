"""The port's corpus pipelines (`parallel/`) against the JAX package's, on
one synthetic model, dictionary and LM, from seeded PCM:

  * `BatchDecodePipeline.decode_corpus` of 5 utterances at batch_size=2
    (the last batch partial) gives the JAX pipeline's (hyp, segments) on
    a one-device CPU mesh, in input order, and the same with two CPU
    replicas of the search, whose rows run at the same time;
  * `TwoStagePipeline` gives the JAX one's;
  * `shard_ctl` is strided; `global_metric_sum` sums over two gloo
    processes (`init_distributed` with a TCP coordinator on localhost);
  * a [1, 2] mesh (tensor parallelism over the "model" axis) gives the
    (1, 1) mesh's results.

The two packages' costs differ within the frontend's tolerances (see
tests/test_torch_slice.py); the results are equal at these seeds."""

import json
import pathlib
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from conftest import cpu_mesh
from pocketsphinx_tpu.frontend.mfcc import MelFrontend as JaxFrontend
from pocketsphinx_tpu.parallel.batch import BatchDecodePipeline as JaxBatch
from pocketsphinx_tpu.parallel.pipeline import TwoStagePipeline as JaxTwoStage
from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend
from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline, make_mesh
from pocketsphinx_tpu_torch.parallel.batch import (global_metric_sum,
                                                   shard_ctl)
from pocketsphinx_tpu_torch.parallel.pipeline import TwoStagePipeline
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import jax_decoder, torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(nfilt=25, lowerf=130, upperf=6800, transform="dct",
           lifter_val=22, remove_noise=True)        # en-us feat.params
SECONDS = (1.2, 0.9, 1.1, 1.2, 1.0)       # sorted: 0.9 1.0 | 1.1 1.2 | 1.2


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("parallel"))
    dic = d + "/small.dic"
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=1)
    lmf = synth.write_arpa(words, d + "/small.arpa", seed=2)
    spec = synth.make_model([dic], seed=3, n_sen=126 + 300, n_density=16)
    jx = jax_decoder(spec, d, dic, lmf, topk=16)
    pt = synth.build_decoder(spec, d, dic, lmf, topk=16, device="cpu")
    pcms = [synth.make_pcm(60 + i, s).astype(np.float32)
            for i, s in enumerate(SECONDS)]
    return jx, pt, pcms


def _key(results):
    return [(h, [(s.word, s.start, s.end) for s in segs])
            for h, segs in results]


@pytest.fixture(scope="module")
def port_corpus(task):
    _, pt, pcms = task
    pipe = BatchDecodePipeline(pt, MelFrontend(**CFG))
    assert pipe.data_parallelism == 1
    return _key(pipe.decode_corpus(pcms, batch_size=2))


def test_decode_corpus_equals_jax(task, port_corpus):
    jx, _, pcms = task
    want = _key(JaxBatch(jx, JaxFrontend(**CFG), mesh=cpu_mesh(1))
                .decode_corpus(pcms, batch_size=2))
    assert port_corpus == want
    assert sum(bool(h) for h, _ in want) >= 3


def test_two_cpu_replicas(task, port_corpus):
    _, pt, pcms = task
    pipe = BatchDecodePipeline(pt, MelFrontend(**CFG),
                               mesh=make_mesh(n_data=2, device="cpu"))
    assert pipe.data_parallelism == 2
    assert pipe.replicas[0] is pt and pipe.replicas[1] is not pt
    for bs in (2, 4):
        assert _key(pipe.decode_corpus(pcms, batch_size=bs)) == port_corpus


def test_replicas_run_concurrently(task, port_corpus, monkeypatch):
    """Each replica decodes its rows in a thread of its own: both enter
    `decode_batch` before either leaves it (a barrier that a serial loop
    would never pass)."""
    _, pt, pcms = task
    pipe = BatchDecodePipeline(pt, MelFrontend(**CFG),
                               mesh=make_mesh(n_data=2, device="cpu"))
    meet = threading.Barrier(2, timeout=60)
    threads = set()
    for rep in pipe.replicas:
        def decode_batch(*a, _inner=rep.decode_batch, **kw):
            threads.add(threading.get_ident())
            meet.wait()
            return _inner(*a, **kw)
        monkeypatch.setattr(rep, "decode_batch", decode_batch)
    # one batch of four: two rows on each replica
    assert _key(pipe.decode_corpus(pcms[:4], batch_size=4)) == \
        port_corpus[:4]
    assert len(threads) == 2 and threading.get_ident() not in threads


def test_two_stage_equals_jax(task, port_corpus):
    jx, pt, pcms = task
    want = _key(JaxTwoStage(jx, JaxFrontend(**CFG)).decode_corpus(pcms))
    got = _key(TwoStagePipeline(pt, MelFrontend(**CFG)).decode_corpus(
        pcms, micro_batch=2))
    assert got == want == port_corpus


def test_tensor_parallel_mesh(task, port_corpus):
    """A [1, 2] ("data", "model") mesh: one replica split over two CPU
    parts gives the (1, 1) mesh's results."""
    _, pt, pcms = task
    mesh = make_mesh(n_data=1, n_model=2, device="cpu")
    assert mesh.shape == {"data": 1, "model": 2}
    assert mesh.devices.shape == (1, 2)
    pipe = BatchDecodePipeline(pt, MelFrontend(**CFG), mesh=mesh)
    assert pipe.data_parallelism == 1
    (rep,) = pipe.replicas
    assert rep.model_devices == [torch.device("cpu")] * 2
    assert _key(pipe.decode_corpus(pcms, batch_size=2)) == port_corpus


def test_shard_ctl_strided():
    ents = [f"utt{i}" for i in range(10)]
    assert shard_ctl(ents, 1, 3) == ["utt1", "utt4", "utt7"]
    assert shard_ctl(ents, 0, 2) + shard_ctl(ents, 1, 2) == \
        ents[0::2] + ents[1::2]
    assert shard_ctl(ents) == ents                 # no process group
    np.testing.assert_array_equal(global_metric_sum([1.5, 2]), [1.5, 2.0])


WORKER = """
import json, sys
from pocketsphinx_tpu_torch.parallel.batch import (
    global_metric_sum, init_distributed, shard_ctl)
rank, n = init_distributed(sys.argv[1], 2, int(sys.argv[2]))
mine = shard_ctl(list(range(7)))
tot = global_metric_sum([len(mine), sum(mine), 0.25 * rank])
print(json.dumps(dict(rank=rank, n=n, mine=mine, tot=tot.tolist(),
                      dtype=str(tot.dtype))))
import torch.distributed as dist
dist.destroy_process_group()
"""


def test_global_metric_sum_two_processes():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, f"localhost:{port}", str(r)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("gloo worker timed out")
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert [o["mine"] for o in outs] == [[0, 2, 4, 6], [1, 3, 5]]
    for r, o in enumerate(outs):
        assert (o["rank"], o["n"]) == (r, 2)
        assert o["tot"] == [7.0, 21.0, 0.25] and o["dtype"] == "float32"
