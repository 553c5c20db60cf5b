"""The n-gram scan through its chunk runner (`base.ChunkGraph`): one CHUNK
of the n-gram step over static buffers, which a CUDA decoder captures as
a CUDA graph and replays, and the CPU runs without capture.

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
  * Each (records, mask) gets records of its own in the decoder's runner
    at one B, sharing its static inputs; a scan at another B drops the
    runner and makes its own; a decoder moved with `to` gets its own
    runner, and
    `Decoder._to(device, graph=False)` passes the choice to its n-gram
    search.
  * Captures run one at a time with the garbage collector stopped, and a
    thread's `tally` counts its own launches only (the replicas of
    `decode_corpus` capture in threads of their own), the others'
    counting in the process's `launches`, which loses no update of
    threads counting at once."""

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
    run = pt.chunk_graph
    assert run.shape == (8, pt.am.n_sen) and not run.graphs
    assert (minimal, False) in run.recs
    assert run.xs[0].shape == (8, pt.CHUNK, pt.am.n_sen)
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


def _jax_carry_equal(pt, carry, jcarry):
    """A B=1 port carry that left the scan equals the JAX scan's carry:
    every chain and CI bucket field, the fan's real columns (the port
    pads its fan carry, the JAX decoder keeps its own width) and the
    single-phone columns; nothing of the renormalization is pending."""
    ch, ci = pt._chain_views(carry["chain"], 1)
    pairs = [(e[k][0], je[k]) for e, je in zip(ch + ci,
                                               jcarry["ch"] + jcarry["ci"],
                                               strict=True) for k in e]
    W = pt.n_multi
    pairs += [(carry["fin"][k][0, ..., :W], jcarry["fin"][k])
              for k in ("S", "TF", "CTX")]
    pairs += [(carry["sp"][k][0], jcarry["sp"][k]) for k in ("S", "TF",
                                                             "CTX")]
    for i, (a, b) in enumerate(pairs):
        if isinstance(b, (tuple, list)):          # one array per state
            b = np.stack([np.asarray(x) for x in b])
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=str(i))
    assert not carry["m_prev"].any()


@pytest.mark.parametrize("minimal", [True, False], ids=["minimal", "full"])
@pytest.mark.parametrize("graph", [True, False], ids=["graph", "eager"])
def test_carry_leaving_the_scan_equals_jax(decoders, graph, minimal):
    """Blocks of 37 and 43 frames through the masked scan, the second
    resumed at t0 = 37 with its last 6 frames padded: records, and the
    carry after each block (the pending renormalization folded in as it
    leaves), equal the JAX `with_carry`'s, through the runner and
    eagerly, with minimal and full records."""
    jx, pt = decoders
    costs = _costs(pt.am.n_sen, 80, seed=45)
    jscan = jx._make_scan(minimal=minimal, mask_carry=True)
    carry = jcarry = None
    for t0, n in ((0, T0), (T0, 80 - T0)):
        valid = np.arange(n) < (n if t0 == 0 else n - 6)
        c = costs[t0:t0 + n]
        recs, carry = pt._scan(torch.as_tensor(c)[None],
                               torch.as_tensor(valid)[None], minimal, carry,
                               t0, mask=True, graph=graph)
        jrecs, jcarry = jscan.with_carry(jnp.asarray(c), jnp.asarray(valid),
                                         jcarry, t0)
        for i, (a, b) in enumerate(zip(recs, jrecs, strict=True)):
            np.testing.assert_array_equal(a[0, :n].numpy(),
                                          np.asarray(b)[:n], err_msg=str(i))
        _jax_carry_equal(pt, carry, jcarry)


def _capture(monkeypatch, module, name):
    """Spy on `module.name`: a list receiving each call's results."""
    seen, fn = [], getattr(module, name)

    def spy(*a, **k):
        seen.append(fn(*a, **k))
        return seen[-1]
    monkeypatch.setattr(module, name, spy)
    return seen


def test_step_leaves_the_renormalization_pending(decoders, monkeypatch):
    """A 3-state decoder's step: the chain and fan carries it returns
    are the kernels' new scores as they wrote them, the frame's `m` is
    pending (`m_prev`) and the kernels of the next frame take it; the
    single-phone columns are renormalized in the step (their best
    score, where it is the frame's, reads 0)."""
    from pocketsphinx_tpu_torch.search import ngram_fused
    _, pt = decoders
    assert pt.NST == 3
    costs = torch.as_tensor(_costs(pt.am.n_sen, 2 * pt.CHUNK, seed=46))
    valid = torch.ones((1, pt.CHUNK), dtype=torch.bool)
    fans = _capture(monkeypatch, ngram_fused, "fan_step")
    chains = _capture(monkeypatch, ngram_fused, "chain_group_step")
    args = []
    for mod, name in ((ngram_fused, "fan_step"),
                      (ngram_fused, "chain_group_step")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, **k: (
            args.append(k["m_prev"].clone()), _f(*a, **k))[1])
    carry = pt.init_carry(1)
    steps = list(pt._steps(carry, costs[None, :pt.CHUNK], valid, 0, False,
                           False))
    assert len(fans) == len(chains) == pt.CHUNK
    prev = torch.zeros(1)
    for i, c, rec in steps:
        m = rec[8]
        assert torch.equal(c["m_prev"], m)
        assert torch.equal(fans[i][0], c["fin"]["S"])
        assert torch.equal(chains[i][0], c["chain"]["S"])
        assert torch.equal(args[2 * i], prev)
        assert torch.equal(args[2 * i + 1], prev)
        prev = m
    assert bool((c["sp"]["S"] <= 0).all())


def test_masked_tail_keeps_the_pending_offset(decoders):
    """Frames whose valid is false leave a row's whole carry as it was,
    its pending renormalization too, while the other row steps on."""
    _, pt = decoders
    c = torch.as_tensor(_costs(pt.am.n_sen, 21 + pt.CHUNK, seed=47))
    c = c[None].expand(2, -1, -1)
    _, carry = pt.with_carry(c[:, :21], torch.ones((2, 21), dtype=torch.bool))
    valid = torch.ones((2, pt.CHUNK), dtype=torch.bool)
    valid[1, 9:] = False
    steps = list(pt._steps(carry, c[:, 21:], valid, 21, False, True))
    held = steps[8][1]
    assert held["m_prev"][1] != 0
    for i, k, rec in steps[9:]:
        assert torch.equal(k["m_prev"][0], rec[8][0])
        assert k["m_prev"][1] == held["m_prev"][1] != rec[8][1]
    ch, hh = (pt._chain_views(x["chain"], 2) for x in (k, held))
    for e, f in zip(ch[0] + ch[1], hh[0] + hh[1], strict=True):
        for key in e:
            assert torch.equal(e[key][1], f[key][1])
    for name in ("fin", "sp"):
        for key in ("S", "TF", "CTX"):
            assert torch.equal(k[name][key][1], held[name][key][1])


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
    ptrs = {x.data_ptr() for x in _fields(pt, pt.chunk_graph.carry)
            if x.numel()}
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
    and stay equal to the uncaptured chunk; the decoder keeps the runner
    of the last one only, whose record kinds share its static inputs;
    `to` gives a decoder a runner of its own."""
    _, pt = decoders
    seen = []
    for lens in ([30, 12, 25], [19], [30, 12, 25]):
        costs, valid = _batch(pt.am.n_sen, lens, seed=50)
        costs, valid = torch.as_tensor(costs), torch.as_tensor(valid)
        for a, b in zip(pt.scan(costs, valid, True),
                        pt.scan(costs, valid, True, graph=False),
                        strict=True):
            assert torch.equal(a, b)
        run = pt.chunk_graph
        assert run.shape == (len(lens), pt.am.n_sen)
        assert set(run.recs) == {(True, False)}
        seen.append(run)
    assert len({id(r) for r in seen}) == 3
    assert seen[0].xs[0] is not seen[2].xs[0]
    pt.scan(costs, valid, False)
    assert pt.chunk_graph is run and set(run.recs) == {(True, False),
                                                       (False, False)}
    assert run.recs[False, False] is not run.recs[True, False]
    other = pt.to("cpu")
    other.scan(costs, valid, True)
    assert other.chunk_graph is not run and pt.chunk_graph is run


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
    counts in the process's `launches`, as a replay's `add_launches`
    does."""
    import threading
    from pocketsphinx_tpu_torch.ops import _build
    inside, outside = threading.Event(), threading.Event()
    before = dict(_build.launches)

    def other():
        inside.wait()
        _build.launched("fan")
        outside.set()

    def grown():
        return {k: v - before.get(k, 0) for k, v in _build.launches.items()
                if v != before.get(k, 0)}

    t = threading.Thread(target=other)
    t.start()
    with _build.tally() as outer:
        _build.launched("fan")
        inside.set()
        outside.wait()
        with _build.tally() as inner:
            _build.launched("chain")
            _build.launched("chain")
        _build.launched("fan")
    t.join()
    assert grown() == {"fan": 1}
    _build.launched("fan")
    _build.add_launches(inner)
    assert outer == {"fan": 2} and inner == {"chain": 2}
    assert grown() == {"fan": 2, "chain": 2}


def test_launch_counter_across_threads():
    """Launches counted from many threads at once, one at a time
    (`launched`, no tally open) and a replay's at once (`add_launches`),
    lose no update."""
    import sys
    import threading
    from pocketsphinx_tpu_torch.ops import _build
    name = "test.threads"
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            (_build.launched(name), _build.add_launches({name: 2}))
            for _ in range(2000)]) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
        got = _build.launches.pop(name, 0)
    assert got == 8 * 2000 * 3


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
