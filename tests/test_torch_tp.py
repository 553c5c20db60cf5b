"""Tensor parallelism over a mesh's "model" axis in the port, against the
unsplit port and the JAX package, on the CPU:

  * the word-transition block split by entry columns
    (`NgramFusedDecoder.shard` over `Mesh([["cpu"] * tp])`, tp = 2 and
    3, the latter with uneven column ranges) gives records bit-equal to
    the unsplit port's scan and to the JAX scan on one cost matrix, in LM
    modes rows, sparse (B) and csr (C, with FAT_CAP low enough that fat
    rows exist), full and minimal records at B=4 with unequal lengths,
    the guard count `nviol` included; `decode_batch` gives the same
    hypotheses, scores and guard counts;
  * the split decoder's chunk runner (`graph=True`, the chunk a card
    captures as one CUDA graph over the group, run on the CPU on the
    same static buffers) equals its eager step (records and the carry
    after the last frame), the unsplit scan and the JAX scan; so does
    `with_carry` from frame 0 and resumed at frame 37 from a carry;
  * each part's static block buffers (`_SplitBuffers`) are made once per
    batch size, shared by the runner and the eager step, and dropped
    with the runners when the batch size changes;
  * each device's block tables hold its column range, with the global
    column ids of the scatters rebased to it (`split_scan_tables`);
  * the senone scoring split over codebooks (tp divides CB) or senone
    slots (it does not), and a fully continuous model split over its
    codebooks, stay within tests/test_torch_acoustic.py's tolerance of
    the unsplit port and of `senone_scores_jax`;
  * `decode_corpus` on `make_mesh(n_data=2, n_model=2, device="cpu")`
    gives the JAX `BatchDecodePipeline`'s (hyp, segments) on a (2, 2)
    ("data", "model") mesh of CPU devices, in all three LM modes, and the
    port's (1, 1) result.  The task has 41 words, so that its E = 100
    entry columns split evenly: the JAX path puts the tables with a
    `NamedSharding`, which refuses an uneven split."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from pocketsphinx_tpu.frontend.mfcc import MelFrontend as JaxFrontend
from pocketsphinx_tpu.models.acoustic import senone_scores_jax
from pocketsphinx_tpu.parallel.batch import BatchDecodePipeline as JaxBatch
from pocketsphinx_tpu.search.ngram_fused import NgramFusedDecoder as JaxNgram
from pocketsphinx_tpu_torch.convert import (column_ranges, scan_tables,
                                            split_scan_tables,
                                            split_scoring_tensors)
from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend
from pocketsphinx_tpu_torch.models.acoustic import senone_scores
from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline, make_mesh
from pocketsphinx_tpu_torch.parallel.batch import Mesh
from pocketsphinx_tpu_torch.search.ngram_fused import NgramFusedDecoder
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import (assert_records_equal, jax_decoder, tie_costs,
                                torch_one_thread)  # noqa: F401

TOPK = 8
FULL = "escore etf etgt ecx entry eprw erw1 erw2 m nviol".split()
MINIMAL = "kv ki etf etgt rank m nviol".split()
LENS = [40, 23, 31, 9]                       # B=4, unequal
ATOL, RTOL = 2e-2, 1e-5                      # tests/test_torch_acoustic.py
MODES = ("rows", "sparse", "csr")
CFG = dict(nfilt=25, lowerf=130, upperf=6800, transform="dct",
           lifter_val=22, remove_noise=True)        # en-us feat.params
SECONDS = (1.2, 0.9, 1.1, 1.2, 1.0)


def _build(spec, d, dic, lmf, mode, **kw):
    """(JAX decoder, port decoder) in LM `mode`; mode C with FAT_CAP=2, so
    that most histories take the fat rows."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PS_LM_MODE", mode)
    if mode == "csr":
        mp.setenv("PS_LM_TABLE_BYTES", "1000")
        mp.setattr(JaxNgram, "FAT_CAP", 2)
        mp.setattr(NgramFusedDecoder, "FAT_CAP", 2)
    try:
        jx = jax_decoder(spec, d, dic, lmf, **kw)
        jx._make_scan()                          # builds the LM tables
        pt = synth.build_decoder(spec, d, dic, lmf, device="cpu", **kw)
    finally:
        mp.undo()
    assert jx.lm_mode == pt.lm_mode == mode
    return jx, pt


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp"))
    dic = d + "/small.dic"
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=4)
    lmf = synth.write_arpa(words, d + "/small.arpa", seed=5)
    spec = synth.make_model([dic], seed=6, n_sen=126 + 300, n_density=8)
    return spec, d, dic, lmf


@pytest.fixture(scope="module", params=MODES)
def decoders(request, task):
    jx, pt = _build(*task, request.param, topk=TOPK)
    if request.param == "csr":
        assert pt.N_FAT > 0
    return jx, pt


@pytest.fixture(scope="module")
def scans(decoders):
    """The JAX and the unsplit port scans of one B=4 cost matrix, by
    record kind: {minimal: (costs, valid, JAX records, port records)}."""
    jx, pt = decoders
    T = max(LENS)
    costs = np.stack([tie_costs(pt.am.n_sen, T, 30 + b)
                      for b in range(len(LENS))])
    valid = np.arange(T)[None, :] < np.asarray(LENS)[:, None]
    out = {}
    for minimal in (False, True):
        rj = jax.vmap(jx._make_scan(minimal=minimal))(jnp.asarray(costs),
                                                      jnp.asarray(valid))
        c, v = torch.as_tensor(costs), torch.as_tensor(valid)
        out[minimal] = (c, v, rj, pt.scan(c, v, minimal=minimal))
    return out


@pytest.mark.parametrize("minimal", [False, True], ids=["full", "minimal"])
@pytest.mark.parametrize("tp", [2, 3])
def test_split_scan_bit_equal(decoders, scans, tp, minimal):
    jx, pt = decoders
    costs, valid, rj, rp = scans[minimal]
    sp = pt.shard(["cpu"] * tp)
    assert sp.tables["columns"] is not None and pt.tables["columns"] is None
    assert [tb["isfill_E"].shape[0] for _, tb in sp.tables["columns"]] == [
        b - a for a, b in column_ranges(pt.nE, tp)]
    names = MINIMAL if minimal else FULL
    got = sp.scan(costs, valid, minimal=minimal)
    assert_records_equal(got, rp, names)
    assert_records_equal(got, rj, names)
    assert int(got[-1].sum()) > 0             # the guard count is live


@pytest.mark.parametrize("tp", [2, 3])
def test_split_decode_batch_equal(decoders, scans, tp):
    jx, pt = decoders
    costs, valid, _, _ = scans[True]
    nf = np.asarray(LENS, np.int32)
    sp = pt.shard(["cpu"] * tp)
    key = lambda o: [(h, [(x.word, x.start, x.end) for x in s])  # noqa: E731
                     for h, s in o]
    want = key(pt.decode_batch(None, nf, keep_records=False, costs=costs))
    got = key(sp.decode_batch(None, nf, keep_records=False, costs=costs))
    assert got == want and sum(bool(h) for h, _ in got) >= 2
    assert sp.hyp_scores == pt.hyp_scores
    assert sp.guard_violations_batch == pt.guard_violations_batch


def test_split_tables_hold_column_ranges(decoders):
    """Each device's block tables are its columns of the whole tables; a
    scatter's global column id becomes its offset in the range, and an
    id outside the range the range's spare column."""
    _, pt = decoders
    whole = scan_tables(pt.host_tables, "cpu")
    ranges = column_ranges(pt.nE, 3)
    lead, parts = split_scan_tables(pt.host_tables, "cpu",
                                    [("cpu", a, b) for a, b in ranges])
    for k in ("rows", "bg", "ctx_next", "fat_rows", "uni_row", "accept_T",
              "accept_E", "isreal_E", "lmwid_E", "bgmeta", "tg2c"):
        assert k not in lead
    for k in ("isfill_E", "fillpen_E", "f0p_E", "maxb_E", "fb_ci"):
        assert torch.equal(lead[k], whole[k]), k
    for (a, b), (_, tb) in zip(ranges, parts):
        for k in ("rows", "bg", "ctx_next", "fat_rows", "fat_ctx",
                  "accept_T", "uni_row", "ctx_base", "isfill_E", "f0p_E"):
            if k in whole:
                w = whole[k][a:b] if whole[k].dim() == 1 else whole[k][:, a:b]
                assert torch.equal(tb[k], w), k
        for k in ("bg_cols", "tg2c", "tg_cols"):
            if k in whole:
                c = whole[k]
                inside = (c >= a) & (c < b)
                assert torch.equal(tb[k], torch.where(inside, c - a, b - a))
                assert tb[k].dtype == c.dtype
    assert column_ranges(10, 3) == [(0, 4), (4, 7), (7, 10)]
    with pytest.raises(ValueError):
        column_ranges(4, 5)


def _scoring_case(task):
    """(port decoder, seeded features [B, T, F, L])."""
    spec, d, dic, lmf = task
    pt = synth.build_decoder(spec, d, dic, lmf, topk=TOPK, device="cpu")
    F, L = spec.means.shape[1], spec.means.shape[3]
    feats = np.random.default_rng(11).normal(0, 2, (2, 13, F, L)).astype(
        np.float32)
    return pt, feats


def _check_scores(got, want, what):
    err = float((got - want).abs().max())
    print(f"{what}: max |split - other| = {err}, bit-equal "
          f"{torch.equal(got, want)}")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("divides", [True, False], ids=["cb", "slot"])
def test_split_scoring_within_tolerance(task, divides):
    pt, feats = _scoring_case(task)
    arrays, groups = pt.am.scoring_arrays, pt.am.cb_groups
    CB = arrays["prec"].shape[0]
    tp = 2 if divides else next(k for k in range(2, CB) if CB % k)
    assert (CB % tp == 0) == divides
    shards = split_scoring_tensors(arrays, groups, ["cpu"] * tp)
    assert [s["axis"] for s in shards] == ["cb" if divides else "slot"] * tp
    got = senone_scores(shards, feats, time_chunk=8)
    whole = senone_scores(pt.am.scoring_tensors("cpu"), feats, time_chunk=8)
    jx = torch.as_tensor(np.array(senone_scores_jax(arrays, groups,
                                                      jnp.asarray(feats))))
    assert got.shape == whole.shape == (2, 13, pt.am.n_sen)
    _check_scores(got, whole, f"tp={tp} vs unsplit port")
    _check_scores(got, jx, f"tp={tp} vs senone_scores_jax")
    # the decoder split over the group scores with its shards
    assert pt.shard(["cpu"] * tp).scoring() is pt.am.scoring_shards(
        ["cpu"] * tp)


def test_split_scoring_continuous():
    """A fully continuous model (one codebook per senone) splits its
    codebooks in near-equal ranges, whatever the group's size."""
    rng = np.random.default_rng(12)
    S, F, D, L = 10, 1, 4, 5
    arrays = dict(prec=rng.uniform(0.1, 1, (S, F, D, L)).astype(np.float32),
                  muprec=rng.normal(0, 1, (S, F, D, L)).astype(np.float32),
                  const=rng.normal(0, 1, (S, F, D)).astype(np.float32),
                  w_lin=rng.dirichlet(np.ones(D), (F, S)).transpose(
                      0, 2, 1).astype(np.float32))
    feats = rng.normal(0, 1, (2, 7, F, L)).astype(np.float32)
    shards = split_scoring_tensors(arrays, {}, ["cpu"] * 3)
    assert [s["prec"].shape[0] for s in shards] == [4, 3, 3]
    got = senone_scores(shards, feats)
    whole = senone_scores(
        split_scoring_tensors(arrays, {}, ["cpu"])[0], feats)
    jx = torch.as_tensor(np.array(senone_scores_jax(arrays, {}, feats)))
    _check_scores(got, whole, "continuous tp=3 vs unsplit port")
    _check_scores(got, jx, "continuous tp=3 vs senone_scores_jax")


@pytest.fixture(scope="module")
def task41(tmp_path_factory):
    """The pipeline task: 41 words, E = 100 entry columns."""
    d = str(tmp_path_factory.mktemp("tp41"))
    dic = d + "/small.dic"
    words = synth.small_dictionary(dic, n_words=41, n_single=3, seed=1)
    lmf = synth.write_arpa(words, d + "/small.arpa", seed=2)
    spec = synth.make_model([dic], seed=3, n_sen=126 + 300, n_density=16)
    pcms = [synth.make_pcm(60 + i, s).astype(np.float32)
            for i, s in enumerate(SECONDS)]
    return (spec, d, dic, lmf), pcms


def _key(results):
    return [(h, [(s.word, s.start, s.end) for s in segs])
            for h, segs in results]


@pytest.mark.parametrize("mode", MODES)
def test_decode_corpus_2x2_equals_jax(task41, mode):
    task, pcms = task41
    jx, pt = _build(*task, mode, topk=16)
    assert pt.nE == 100
    mesh = make_mesh(n_data=2, n_model=2, device="cpu")
    assert mesh.shape == {"data": 2, "model": 2}
    pipe = BatchDecodePipeline(pt, MelFrontend(**CFG), mesh=mesh)
    assert all(r.model_devices is not None for r in pipe.replicas)
    got = _key(pipe.decode_corpus(pcms, batch_size=4))
    one = _key(BatchDecodePipeline(pt, MelFrontend(**CFG)).decode_corpus(
        pcms, batch_size=2))
    jmesh = JaxMesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2),
                    ("data", "model"))
    want = _key(JaxBatch(jx, JaxFrontend(**CFG), mesh=jmesh)
                .decode_corpus(pcms, batch_size=4))
    assert got == want == one
    assert sum(bool(h) for h, _ in want) >= 3


def test_mesh_shapes(monkeypatch):
    """`make_mesh` lays the first n_data * n_model cards out row by row and
    refuses more than exist; an explicit mesh may name one device twice
    along "model" (two parts on one card)."""
    m = Mesh([["cpu", "cpu"]])
    assert m.shape == {"data": 1, "model": 2}
    assert make_mesh(n_data=3, n_model=2, device="cpu").devices.shape == (
        3, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    def cards(m):
        return [[d.index for d in row] for row in m.devices]
    assert cards(make_mesh(2, 2)) == [[0, 1], [2, 3]]
    assert cards(make_mesh(1, 2)) == [[0, 1]]
    assert cards(make_mesh(n_model=2)) == [[0, 1], [2, 3]]
    assert cards(make_mesh()) == [[0], [1], [2], [3]]
    for nd, nm in ((3, 2), (1, 5), (5, 1)):
        with pytest.raises(ValueError, match="CUDA devices"):
            make_mesh(nd, nm)


def _carry_equal(dec, a, b):
    for (n, x), (_, y) in zip(dec._carry_fields(a), dec._carry_fields(b),
                              strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y), n


@pytest.mark.parametrize("minimal", [False, True], ids=["full", "minimal"])
@pytest.mark.parametrize("tp", [2, 3])
def test_split_runner_equals_eager(decoders, scans, tp, minimal):
    """Through the chunk runner and stepped eagerly: records and carry
    equal, and the records equal the unsplit scan's and the JAX scan's."""
    _, pt = decoders
    costs, valid, rj, rp = scans[minimal]
    sp = pt.shard(["cpu"] * tp)
    rg, cg = sp._scan(costs, valid, minimal, graph=True)
    run = sp._graphs["runs"][minimal, False]
    assert run.graph is None and run.io.costs.shape[0] == len(LENS)
    re, ce = sp._scan(costs, valid, minimal, graph=False)
    names = MINIMAL if minimal else FULL
    assert_records_equal(rg, re, names)
    assert_records_equal(rg, rp, names)
    assert_records_equal(rg, rj, names)
    _carry_equal(sp, cg, ce)
    assert sp.graph and int(rg[-1].sum()) > 0


@pytest.mark.parametrize("tp", [2, 3])
def test_split_with_carry_resumed(decoders, tp):
    """`with_carry` over blocks of 37 and 43 frames at B=2, the second
    resumed at frame 37 from the first one's carry: through the runner,
    the records and carries equal the eager split step's and the
    unsplit runner's."""
    _, pt = decoders
    costs = torch.as_tensor(np.stack([tie_costs(pt.am.n_sen, 80, 60 + b)
                                      for b in range(2)]))
    valid = torch.ones((2, 80), dtype=torch.bool)
    valid[1, 70:] = False
    sp = pt.shard(["cpu"] * tp)
    outs = []
    for dec, graph in ((sp, True), (sp, False), (pt, True)):
        r1, k1 = dec.with_carry(costs[:, :37], valid[:, :37], graph=graph)
        r2, k2 = dec.with_carry(costs[:, 37:], valid[:, 37:], k1, 37,
                                graph=graph)
        outs.append(([r[:, :37] for r in r1] + [r[:, :43] for r in r2],
                     k1, k2))
    for recs, k1, k2 in outs[1:]:
        assert_records_equal(recs, outs[0][0], FULL * 2)
        _carry_equal(sp, outs[0][1], k1)
        _carry_equal(sp, outs[0][2], k2)
    assert (outs[0][0][11] > 37).any()        # entries stamped after t0


def test_split_buffers_once_per_batch_size(decoders, scans, monkeypatch):
    """The block buffers of a split decoder: one set per batch size,
    shared by the runners and the eager step (made once), each part's
    outputs over its column range and the joined [B, E] on the lead; an
    eager step at another B makes its own while the runners keep theirs,
    which a later capture at their B writes again; a scan at another B
    makes new ones with its runners and drops the old; a decoder moved
    with `shard` gets its own."""
    import weakref
    from pocketsphinx_tpu_torch.search import ngram_fused as nf
    _, pt = decoders
    costs, valid, _, _ = scans[True]
    B = len(LENS)
    made = []
    init = nf._SplitBuffers.__init__

    def count(self, dec, b):
        made.append(b)
        init(self, dec, b)

    monkeypatch.setattr(nf._SplitBuffers, "__init__", count)
    sp = pt.shard(["cpu"] * 3)
    sp.scan(costs, valid, True, graph=False)
    first = sp._split_buffers(B)
    sp.scan(costs, valid, True)
    sp.scan(costs, valid, False)
    sp.scan(costs, valid, False, graph=False)
    buf = sp._graphs["split"]
    assert made == [B] and buf is first and sp._split_buffers(B) is buf
    widths = [b - a for a, b in column_ranges(pt.nE, 3)]
    for p, w in zip(buf.parts, widths, strict=True):
        assert p.stream is None and p.exits is None
        assert p.lead_outs is p.outs
        assert [tuple(o.shape) for o in p.outs] == [(B, w)] * 7
    assert [tuple(o.shape) for o in buf.joined] == [(B, pt.nE)] * 7
    # an eager step at another B replaces the eager set; the graphs keep
    # theirs, and a later capture at B writes those again
    sp.scan(costs[:2], valid[:2], True, graph=False)
    assert made == [B, 2] and sp._split.B == 2 and sp._graphs["split"] is buf
    sp.with_carry(costs, valid)
    assert made == [B, 2] and sp._split is buf
    old = weakref.ref(buf)
    del buf, first
    sp.scan(costs[:2], valid[:2], True)
    assert made == [B, 2, 2] and old() is None
    assert sp._graphs["split"].B == 2 and sp._graphs["shape"][0] == 2
    assert sp._split is sp._graphs["split"]
    twin = sp.shard(["cpu"] * 3)
    twin.scan(costs[:2], valid[:2], True)
    assert made == [B, 2, 2, 2]
    assert twin._graphs["split"] is not sp._graphs["split"]
    assert pt.__dict__.get("_split") is None
