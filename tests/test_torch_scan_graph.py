"""The scan's chunk runner (`_ScanGraph`): one CHUNK of the n-gram step
over static buffers, which a CUDA decoder captures as a CUDA graph and
replays, and the CPU runs without capture.

  * The runner's records (B=8, unequal lengths, minimal and full) are
    bit-equal to the JAX `_make_scan`'s, and records and carry to the
    port's eager step (`graph=False`).
  * `with_carry` from t0 = 37, and resumed at t0 = 37 from a carry,
    equals the JAX `with_carry`; its TF values are the t0 = 0 run's
    offset by t0.
  * A carry `with_carry` returned is the caller's: later calls leave it
    as it was.
  * The frame index given as a 0-d int32 tensor (the graph's) gives the
    records and carry it gives as an int.
  * Each (records, mask) gets a runner of its own at one B, sharing its
    static inputs; a scan at another B drops them and makes its own; a
    decoder moved with `to` gets its own runners, and
    `Decoder._to(device, graph=False)` passes the choice to its n-gram
    search.
  * Captures run one at a time with the garbage collector stopped, and a
    thread's `tally` counts its own launches only (the replicas of
    `decode_corpus` capture in threads of their own)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_helpers import jax_decoder, torch_one_thread  # noqa: F401
from pocketsphinx_tpu_torch.testing import synth

TOPK = 8
LENS = [50, 33, 17, 50, 41, 9, 26, 48]          # B=8, unequal
T0 = 37                                         # not a multiple of CHUNK


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scan_graph"))
    dic = d + "/small.dic"
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=2)
    lmf = synth.write_arpa(words, d + "/small.arpa", seed=3)
    spec = synth.make_model([dic], seed=4, n_sen=126 + 300, n_density=8)
    return (jax_decoder(spec, d, dic, lmf, topk=TOPK),
            synth.build_decoder(spec, d, dic, lmf, topk=TOPK, device="cpu"))


def _costs(n_sen, T, seed):
    c = np.random.default_rng(seed).uniform(0, 400, (T, n_sen)).astype(
        np.float32)
    c[T // 3] = 1e29          # every score collapses onto one value: ties
    return c


def _batch(n_sen, lens, seed):
    costs = np.stack([_costs(n_sen, max(lens), seed + b)
                      for b in range(len(lens))])
    valid = np.arange(max(lens))[None, :] < np.asarray(lens)[:, None]
    return costs, valid


def _fields(pt, carry):
    return [x for _, x in pt._carry_fields(carry)]


def _assert_carry_equal(pt, a, b):
    for x, y in zip(_fields(pt, a), _fields(pt, b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("minimal", [True, False], ids=["minimal", "full"])
def test_runner_equals_jax_scan(decoders, minimal):
    jx, pt = decoders
    costs, valid = _batch(pt.am.n_sen, LENS, seed=20)
    rj = jax.vmap(jx._make_scan(minimal=minimal))(jnp.asarray(costs),
                                                  jnp.asarray(valid))
    rp = pt.scan(torch.as_tensor(costs), torch.as_tensor(valid),
                 minimal=minimal, graph=True)
    run = pt._graphs["runs"][minimal, False]
    assert pt._graphs["shape"] == (8, pt.am.n_sen) and run.graph is None and run.io.costs.shape == (8, pt.CHUNK,
                                                        pt.am.n_sen)
    assert len(rj) == len(rp) == (7 if minimal else 10)
    for i, (a, b) in enumerate(zip(rj, rp)):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype, i
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(i))


@pytest.mark.parametrize("minimal", [True, False], ids=["minimal", "full"])
def test_runner_equals_eager_step(decoders, minimal):
    """Records and the carry after the last frame: the runner's (a copy
    of its static carry) and the eager step's."""
    _, pt = decoders
    costs, valid = _batch(pt.am.n_sen, LENS, seed=30)
    costs, valid = torch.as_tensor(costs), torch.as_tensor(valid)
    rg, cg = pt._scan(costs, valid, minimal, graph=True)
    re, ce = pt._scan(costs, valid, minimal, graph=False)
    for a, b in zip(rg, re, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _assert_carry_equal(pt, cg, ce)


def _jax_blocks(jx, costs, blocks):
    """The JAX `with_carry` over `blocks` [(t0, a, b)]: rows [a, b) of
    costs [T, n_sen] numbered from frame t0, each block from the last
    one's carry."""
    jscan = jx._make_scan(mask_carry=True)
    out, carry = [], None
    for t0, a, b in blocks:
        recs, carry = jscan.with_carry(
            jnp.asarray(costs[a:b]), jnp.ones(b - a, bool), carry, t0)
        out.append([np.asarray(r)[:b - a] for r in recs])
    return out


def _port_blocks(pt, costs, blocks, graph=True):
    """`_jax_blocks` through the port's `with_carry` at B=1."""
    out, carry = [], None
    for t0, a, b in blocks:
        recs, carry = pt.with_carry(
            torch.as_tensor(costs[a:b])[None],
            torch.ones((1, b - a), dtype=torch.bool), carry, t0,
            graph=graph)
        out.append([r[0, :b - a].numpy() for r in recs])
    return out, carry


def test_with_carry_from_t0_equals_jax(decoders):
    """From t0 = 37: every record equals the JAX `with_carry`'s, and the
    exits' TF values are the t0 = 0 run's offset by 37 (0, the start,
    stays 0)."""
    jx, pt = decoders
    costs = _costs(pt.am.n_sen, 40, seed=40)
    got = _port_blocks(pt, costs, [(T0, 0, 40)])[0][0]
    want = _jax_blocks(jx, costs, [(T0, 0, 40)])[0]
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    base = _port_blocks(pt, costs, [(0, 0, 40)])[0][0]
    etf, etf0 = got[1], base[1]
    assert (etf0 > 0).any()
    np.testing.assert_array_equal(etf, np.where(etf0 > 0, etf0 + T0, 0))
    for i in (0, 2, 3, 4, 5, 6, 7, 8, 9):
        np.testing.assert_array_equal(got[i], base[i], err_msg=str(i))


def test_with_carry_resumed_at_t0_equals_jax_and_eager(decoders):
    """Blocks of 37 and 43 frames, the second resumed at t0 = 37 from the
    first one's carry: records equal the JAX blocks', and records and
    carry the eager step's."""
    jx, pt = decoders
    costs = _costs(pt.am.n_sen, 80, seed=41)
    blocks = [(0, 0, T0), (T0, T0, 80)]
    got, carry = _port_blocks(pt, costs, blocks)
    eager, carry_e = _port_blocks(pt, costs, blocks, graph=False)
    want = _jax_blocks(jx, costs, blocks)
    for g, e, w in zip(got, eager, want, strict=True):
        for i, (a, b, c) in enumerate(zip(g, e, w, strict=True)):
            np.testing.assert_array_equal(a, c, err_msg=str(i))
            np.testing.assert_array_equal(a, b, err_msg=str(i))
    _assert_carry_equal(pt, carry, carry_e)


def test_with_carry_returns_the_callers_carry(decoders):
    """A carry `with_carry` returned lies in buffers of its own: neither
    the runner's static carry nor a later call (another input, from no
    carry and from this carry) changes it."""
    _, pt = decoders
    costs = torch.as_tensor(_costs(pt.am.n_sen, 40, seed=42))[None]
    other = torch.as_tensor(_costs(pt.am.n_sen, 40, seed=43))[None]
    valid = torch.ones((1, 40), dtype=torch.bool)
    _, carry = pt.with_carry(costs, valid)
    kept = [x.clone() for x in _fields(pt, carry)]
    run = pt._graphs["runs"][False, True]
    ptrs = {x.data_ptr() for x in _fields(pt, run.io.carry) if x.numel()}
    assert not ptrs & {x.data_ptr() for x in _fields(pt, carry)}
    pt.with_carry(other, valid)
    _, nxt = pt.with_carry(other, valid, carry, 40)
    for x, y in zip(_fields(pt, carry), kept, strict=True):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, y) for x, y in zip(
        _fields(pt, nxt), kept, strict=True))


@pytest.mark.parametrize("mask", [False, True])
def test_frame_index_tensor_equals_int(decoders, mask):
    """One chunk from frame 21 of a carry 21 frames in, its frame index
    an int and a 0-d int32 tensor: the same records and carry."""
    _, pt = decoders
    costs = torch.as_tensor(_costs(pt.am.n_sen, 21 + pt.CHUNK, seed=44))
    valid = torch.ones((2, pt.CHUNK), dtype=torch.bool)
    valid[1, 9:] = False
    c = costs[None].expand(2, -1, -1)
    _, carry = pt.with_carry(c[:, :21], torch.ones((2, 21), dtype=torch.bool))
    outs = []
    for t in (21, torch.tensor(21, dtype=torch.int32)):
        steps = list(pt._steps(carry, c[:, 21:], valid, t, False, mask))
        assert [i for i, _, _ in steps] == list(range(pt.CHUNK))
        outs.append((steps[-1][1], [torch.stack(r, 1) for r in zip(
            *(rec for _, _, rec in steps))]))
    (ca, ra), (cb, rb) = outs
    for a, b in zip(ra, rb, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _assert_carry_equal(pt, ca, cb)
    assert (ra[1] > 21).any()              # entries stamped tf = t + 1


def test_runners_per_shape_and_decoder(decoders):
    """Two batch sizes on one decoder, in turn, get runners of their own
    and stay equal to the eager step; the decoder keeps the runners of
    the last one only, whose record kinds share one static input; `to`
    gives a decoder runners of its own."""
    _, pt = decoders
    seen = []
    for lens in ([30, 12, 25], [19], [30, 12, 25]):
        costs, valid = _batch(pt.am.n_sen, lens, seed=50)
        costs, valid = torch.as_tensor(costs), torch.as_tensor(valid)
        for a, b in zip(pt.scan(costs, valid, True),
                        pt.scan(costs, valid, True, graph=False),
                        strict=True):
            assert torch.equal(a, b)
        assert pt._graphs["shape"] == (len(lens), pt.am.n_sen)
        assert set(pt._graphs["runs"]) == {(True, False)}
        seen.append(pt._graphs["runs"][True, False])
    assert len({id(r) for r in seen}) == 3
    assert seen[0].io is not seen[2].io
    pt.scan(costs, valid, False)
    runs = pt._graphs["runs"]
    assert runs[False, False] is not runs[True, False]
    assert runs[False, False].io is runs[True, False].io
    other = pt.to("cpu")
    other.scan(costs, valid, True)
    assert other._graphs is not pt._graphs
    assert other._graphs["runs"][True, False] is not runs[True, False]


def test_decoder_graph_argument(tmp_path):
    """`Decoder._to(device, graph=False)` sets its n-gram search's choice
    and leaves this decoder's (the graph, the default) as it was; both
    decode the same costs alike."""
    from pocketsphinx_tpu_torch import Decoder
    hmm, dic, lmf = synth.small_task(str(tmp_path), seed=7)
    dec = Decoder(hmm=hmm, dict=dic, lm=lmf, device="cpu")
    assert dec._searches["_default"].graph is True
    twin = dec._to("cpu", graph=False)
    assert twin._searches["_default"].graph is False
    assert dec._searches["_default"].graph is True
    assert dec._to("cpu")._searches["_default"].graph is True
    costs = np.random.default_rng(11).uniform(
        0, 400, (70, dec.am.n_sen)).astype(np.float32)
    for d in (dec, twin):
        d.decode_senscr(costs)
    for a, b in zip(dec._searches["_default"].raw_records,
                    twin._searches["_default"].raw_records, strict=True):
        np.testing.assert_array_equal(a, b)
    assert dec.hyp().hypstr == twin.hyp().hypstr


def test_tally_counts_its_own_thread():
    """A launch counts in the open `tally` of the thread that makes it,
    nested tallies restore the outer one, and a thread without one
    leaves the count to the wrapper."""
    import threading
    from pocketsphinx_tpu_torch.ops import _build
    inside, outside = threading.Event(), threading.Event()
    got = {}

    def other():
        inside.wait()
        got["other"] = _build.tallied("fan")
        outside.set()

    t = threading.Thread(target=other)
    t.start()
    with _build.tally() as outer:
        assert _build.tallied("fan")
        inside.set()
        outside.wait()
        with _build.tally() as inner:
            assert _build.tallied("chain") and _build.tallied("chain")
        assert _build.tallied("fan")
    t.join()
    assert got["other"] is False and not _build.tallied("fan")
    assert outer == {"fan": 2} and inner == {"chain": 2}


def test_graph_capture_one_at_a_time(monkeypatch):
    """Captures from two threads at once (torch's capture replaced by a
    stand-in that waits): one runs at a time, the garbage collector is
    stopped through each, and it is on again after the last."""
    import contextlib
    import gc
    import threading
    import time
    import pocketsphinx_tpu_torch as ptt
    state = {"in": 0, "most": 0, "gc_on": []}

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        state["in"] += 1
        state["most"] = max(state["most"], state["in"])
        state["gc_on"].append(gc.isenabled())
        time.sleep(0.05)
        yield
        state["gc_on"].append(gc.isenabled())
        state["in"] -= 1

    monkeypatch.setattr(torch.cuda, "graph", graph)
    start = threading.Barrier(2)

    def capture():
        start.wait()
        with ptt.graph_capture(object()):
            time.sleep(0.02)

    assert gc.isenabled()
    threads = [threading.Thread(target=capture) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert state["most"] == 1 and state["gc_on"] == [False] * 4
    assert gc.isenabled()
