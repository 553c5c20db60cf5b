"""The word-transition block as one op (`pocketsphinx_tpu_torch.ops.
transitions`, which `transitions` runs as its plain version for CPU
tensors) in the port's fused n-gram scan, against the JAX package's scan
on the same synthetic model, dictionary, seeded ARPA LM and cost
matrices with tied frames:

  * the full records of `decode`, the minimal records of a B=8 scan with
    unequal lengths and `decode_batch` at B=8 are bit-equal to JAX in LM
    modes rows, B and C: with K = W (no shortlist), with the trigram
    corrections through `tg2c` and through the flat `tg_cols`
    (PS_TG2D_BYTES=0), and with fat histories (FAT_CAP=2); the scan
    calls the op once per frame;
  * the op over the parts of a "model" group (tp 2 and 3, the parts'
    own column ranges and rebased scatter ids) joins to the unsplit op,
    on a real frame's exits and on the same exits with ties;
  * within each history's CSR bigram row and each context's trigram row
    the entry columns are unique (the overlays' order does not matter),
    on bench-1.7k's LM and on a seeded ARPA LM;
  * the op given `out=` fills the given tensors, equal to the allocating
    call, whole and per part;
  * the packed accept table (one or more 64-bit words per column), the
    kernel's sorted overlay copies (whole and per part), its default
    launch shape, and the op's checks; a CPU call never loads the CUDA
    library."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import pocketsphinx_tpu.models.acoustic as jax_acoustic
from pocketsphinx_tpu.search.ngram_fused import NgramFusedDecoder as JaxNgram
from pocketsphinx_tpu_torch.convert import accept_bits
from pocketsphinx_tpu_torch.lm.ngram import read_lm
from pocketsphinx_tpu_torch.ops import _build
from pocketsphinx_tpu_torch.ops import transitions as tr
from pocketsphinx_tpu_torch.search import ngram_fused
from pocketsphinx_tpu_torch.search.ngram_fused import NgramFusedDecoder
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import (assert_records_equal, jax_decoder, tie_costs,
                                torch_one_thread)  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = "escore etf etgt ecx entry eprw erw1 erw2 m nviol".split()
MINIMAL = "kv ki etf etgt rank m nviol".split()
LENS = [40, 23, 31, 9, 40, 17, 35, 28]             # B=8, unequal
KW = 10 ** 6                                       # topk: K = W

#: (LM mode, topk, FAT_CAP or None, trigram rows in the 2-D tg2c table)
CASES = {"rows_kw": ("rows", KW, None, True),
         "sparse_tg2c": ("sparse", 8, None, True),
         "sparse_flat": ("sparse", 8, None, False),
         "csr_fat_flat": ("csr", 8, 2, False),
         "csr_kw": ("csr", KW, None, True)}


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("transitions")
    dic = str(d / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=6)
    lmf = synth.write_arpa(words, str(d / "small.arpa"), seed=8)
    spec = synth.make_model([dic], seed=9, n_sen=126 + 300, n_density=8)
    return d, dic, lmf, spec


@pytest.fixture(scope="module", params=list(CASES))
def decoders(request, task):
    """(JAX decoder, port decoder) of one case of `CASES`."""
    d, dic, lmf, spec = task
    mode, topk, fat_cap, tg2d = CASES[request.param]
    mp = pytest.MonkeyPatch()
    mp.setenv("PS_LM_MODE", mode)
    if mode == "csr":
        mp.setenv("PS_LM_TABLE_BYTES", "1000")
    if fat_cap is not None:
        mp.setattr(JaxNgram, "FAT_CAP", fat_cap)
        mp.setattr(NgramFusedDecoder, "FAT_CAP", fat_cap)
    if not tg2d:
        mp.setenv("PS_TG2D_BYTES", "0")
    try:
        jx = jax_decoder(spec, str(d), dic, lmf, topk=topk)
        jx._make_scan()                      # builds the LM tables
        pt = synth.build_decoder(spec, str(d), dic, lmf, topk=topk,
                                 device="cpu")
    finally:
        mp.undo()
    assert jx.lm_mode == pt.lm_mode == mode
    if mode != "rows":
        assert pt.S_TRI > 0 and ("tg2c" in pt.tables) == tg2d
    assert (pt.K == pt.W) == (topk == KW)
    assert (pt.N_FAT > 0) == (fat_cap is not None)
    if mode == "csr" and fat_cap is None:
        assert pt.SB > 0                     # CSR rows, not only fat ones
    return jx, pt


@pytest.fixture
def op_calls(monkeypatch):
    """The arguments of every call of the op from the scan."""
    seen, inner = [], ngram_fused.transitions

    def spy(*a, **k):
        seen.append(a)
        return inner(*a, **k)
    monkeypatch.setattr(ngram_fused, "transitions", spy)
    return seen


def _batch(n_sen, seed):
    T = max(LENS)
    costs = np.stack([tie_costs(n_sen, T, seed + b) for b in range(8)])
    return costs, np.asarray(LENS, np.int32)


def test_decode_full_records_equal_jax(decoders, op_calls):
    jx, pt = decoders
    costs = tie_costs(pt.am.n_sen, 45, seed=3)
    hj, sj = jx.decode(None, costs=costs)
    hp, sp = pt.decode(None, costs=costs)
    assert_records_equal(pt.raw_records, jx.raw_records, FULL)
    key = lambda s: [(x.word, x.start, x.end) for x in s]  # noqa: E731
    assert (hp, key(sp)) == (hj, key(sj)) and hp
    assert pt.hyp_score == jx.hyp_score
    assert pt.guard_violations == jx.guard_violations
    # one op call per frame stepped (whole chunks), on the decoder's tables
    assert len(op_calls) == -(-45 // pt.CHUNK) * pt.CHUNK
    assert all(a[0] is pt.tables and a[1] == pt.lm_layout for a in op_calls)


def test_minimal_records_equal_jax(decoders):
    jx, pt = decoders
    costs, nf = _batch(pt.am.n_sen, seed=20)
    valid = np.arange(costs.shape[1])[None, :] < nf[:, None]
    rj = jax.vmap(jx._make_scan(minimal=True))(jnp.asarray(costs),
                                               jnp.asarray(valid))
    rp = pt.scan(torch.as_tensor(costs), torch.as_tensor(valid),
                 minimal=True)
    assert_records_equal(rp, rj, MINIMAL)


def test_decode_batch_equal_jax(decoders, monkeypatch):
    jx, pt = decoders
    costs, nf = _batch(pt.am.n_sen, seed=40)
    monkeypatch.setattr(jax_acoustic, "senone_scores_jax",
                        lambda *a, **k: jnp.asarray(costs))
    feats = np.zeros(costs.shape[:2] + (3, 13), np.float32)
    oj = jx.decode_batch(feats, nf, keep_records=False)
    op = pt.decode_batch(None, nf, keep_records=False,
                         costs=torch.as_tensor(costs))
    key = lambda o: [(h, [(x.word, x.start, x.end) for x in s])  # noqa: E731
                     for h, s in o]
    assert key(op) == key(oj)
    assert sum(bool(h) for h, _ in op) >= 4
    assert pt.hyp_scores == jx.hyp_scores
    assert pt.guard_violations_batch == jx.guard_violations_batch


@pytest.mark.parametrize("tp", [2, 3])
def test_split_op_joins_to_unsplit(decoders, tp):
    """Each part's op over its column range, joined in column order,
    equals the unsplit op on the same exits (real and tied)."""
    _, pt = decoders
    costs = torch.as_tensor(tie_costs(pt.am.n_sen, 2 * pt.CHUNK, seed=11,
                                      tie_frame=2 * pt.CHUNK - 1))
    real = chip_smoke.frame_exits(pt, torch.stack([costs, costs.flip(0)]))[0]
    sp = pt.shard(["cpu"] * tp)
    parts = sp.tables["columns"]
    assert len(parts) == tp
    for args in (real, chip_smoke.tie_exits(real, np.random.default_rng(tp))):
        whole = tr.transitions(*args)
        got = [tr.transitions(tb, *args[1:]) for _, tb in parts]
        for i, w in enumerate(whole):
            assert torch.equal(torch.cat([g[i] for g in got], 1), w), i
    # the decoder's own split scan reaches the op once per part and frame
    seen = chip_smoke.frame_exits(sp, costs[None])
    assert len(seen) == tp
    assert all(a[0] is tb for a, (_, tb) in zip(seen, parts))


def _assert_rows_unique(nxt, cols, what):
    """Within each row [nxt[i], nxt[i+1]) of `cols`, no column repeats."""
    nxt = np.asarray(nxt, np.int64)
    row = np.repeat(np.arange(len(nxt) - 1), np.diff(nxt))
    key = row * (int(np.max(cols, initial=0)) + 1) + np.asarray(cols)
    assert len(np.unique(key)) == len(key), what
    assert len(key) > 0, what


@pytest.mark.parametrize("lm_name", ["bench-1.7k", "seeded_arpa"])
def test_overlay_columns_unique(task, lm_name):
    """`bigram_csr` and `trigram_corrections` over entry columns with
    alternates (several columns per word) give each history's row, and
    each bigram context's row, unique columns."""
    if lm_name == "bench-1.7k":
        lm = read_lm(os.path.join(ROOT, "bench_data", "bench-1.7k.lm.bin"),
                     lw=6.5, wip=0.65)
    else:
        lm = read_lm(task[2], lw=6.5, wip=0.65)
    V = lm.counts[0]
    # every word one column, every third word a second one (alternates)
    cols = np.concatenate([np.arange(V), np.arange(0, V, 3)])
    skip = np.zeros(len(cols), bool)
    skip[V - 1] = True                       # a filler column
    bg_next, bg_cols, _, _ = lm.bigram_csr(cols, skip=skip)
    _assert_rows_unique(bg_next, bg_cols, f"{lm_name} bigram rows")
    tgc_next, tg_cols, _, _ = lm.trigram_corrections(cols)
    _assert_rows_unique(tgc_next, tg_cols, f"{lm_name} trigram rows")


def test_decoder_overlay_tables_unique(decoders):
    """The scan's own tables: each history's kept CSR row (umeta) and
    each bigram context's trigram row (bgmeta) hold unique columns."""
    _, pt = decoders
    tb = pt.tables
    if pt.lm_mode == "rows":
        assert "bgmeta" not in tb
        return
    meta = tb["bgmeta"].numpy().astype(np.int64)
    for h in range(meta.shape[0]):
        n = min(meta[h, 4], pt.S_TRI)
        c = (tb["tg2c"][h, :n] if "tg2c" in tb
             else tb["tg_cols"][meta[h, 3]:meta[h, 3] + n]).numpy()
        assert len(np.unique(c)) == n, h
    if pt.lm_mode == "csr":
        um = tb["umeta"].numpy().astype(np.int64)
        for h in range(um.shape[0]):
            c = tb["bg_cols"][um[h, 0]:um[h, 0] + um[h, 1]].numpy()
            assert len(np.unique(c)) == len(c), h


def test_accept_bits():
    rng = np.random.default_rng(0)
    acc = (rng.random((50, 42)) < 0.5).astype(np.float32)
    bits = accept_bits(acc).view(np.uint64)
    assert bits.shape == (1, 50)
    for c in (0, 13, 41):
        np.testing.assert_array_equal((bits[0] >> np.uint64(c))
                                      & np.uint64(1), acc[:, c])
    full = np.ones((3, 64), np.float32)
    assert accept_bits(full).view(np.uint64)[0, 0] == np.uint64(2 ** 64 - 1)
    assert accept_bits(np.full((3, 4), 0.5, np.float32)) is None


@pytest.mark.parametrize("n_ci", [64, 65, 130])
def test_accept_bits_words(n_ci):
    """Past 64 phones the table packs into ceil(n / 64) words per column,
    [NW, E]: phone c is bit c % 64 of word c // 64; the last word's
    unused bits are 0."""
    rng = np.random.default_rng(n_ci)
    acc = (rng.random((37, n_ci)) < 0.5).astype(np.float32)
    acc[0] = 1.0
    bits = accept_bits(acc).view(np.uint64)
    nw = -(-n_ci // 64)
    assert bits.shape == (nw, 37) and bits.dtype == np.uint64
    for c in range(n_ci):
        np.testing.assert_array_equal(
            (bits[c // 64] >> np.uint64(c % 64)) & np.uint64(1), acc[:, c])
    tail = n_ci - 64 * (nw - 1)
    want = np.uint64(2 ** tail - 1) if tail < 64 else np.uint64(2 ** 64 - 1)
    assert bits[-1, 0] == want


def _rows_of(cols, off, cnt, *vals):
    """{row: sorted [(col, *vals)]} of rows [off, off + cnt)."""
    return {r: sorted(zip(*(np.asarray(x).reshape(-1)[o:o + n].tolist()
                            for x in (cols,) + vals)))
            for r, (o, n) in enumerate(zip(off, cnt))}


def _sorted_row(c, nE):
    """Ascending columns, each once, then the spare column's ids."""
    inside = c[c < nE]
    return (np.diff(inside) > 0).all() and (c[len(inside):] == nE).all()


def _check_overlays(tb, what):
    """The kernel's copies of a block table set: each row holds the
    original row's (column, value, context) entries, in ascending column
    order (a part's spare column last); entries outside every row keep
    their place."""
    nE = tb["isfill_E"].shape[0]
    if "umeta" in tb and "bg_cols" in tb:
        um = tb["umeta"].numpy().astype(np.int64)
        off, cnt = um[:, 0], um[:, 1]
        got = _rows_of(tb["tr_bg_cols"], off, cnt, tb["tr_bg_vals"],
                       tb["tr_bg_ctx"])
        assert got == _rows_of(tb["bg_cols"], off, cnt, tb["bg_vals"],
                               tb["bg_ctx"]), what
        c = tb["tr_bg_cols"].numpy()
        assert tb["tr_bg_cols"].dtype == torch.int32
        for o, n in zip(off, cnt):
            assert _sorted_row(c[o:o + n], nE), what
        used = np.zeros(len(c), bool)
        for o, n in zip(off, cnt):
            used[o:o + n] = True
        np.testing.assert_array_equal(c[~used],
                                      tb["bg_cols"].numpy()[~used])
    if "bgmeta" not in tb:
        return
    meta = tb["bgmeta"].numpy().astype(np.int64)
    two_d = "tg2c" in tb
    if not two_d and "tg_cols" not in tb:
        return
    cols = tb["tg2c" if two_d else "tg_cols"]
    vals = tb["tg2v" if two_d else "tg_vals"]
    S = cols.shape[-1] if two_d else 0
    off = np.arange(len(meta)) * S if two_d else meta[:, 3]
    cnt = meta[:, 4]
    assert tb["tr_tg_cols"].shape == cols.shape
    assert _rows_of(tb["tr_tg_cols"], off, cnt, tb["tr_tg_vals"]) == \
        _rows_of(cols, off, cnt, vals), what
    c = tb["tr_tg_cols"].numpy().reshape(-1)
    for o, n in zip(off, cnt):
        assert _sorted_row(c[o:o + n], nE), what


def test_kernel_overlays_sorted(decoders):
    """The kernel's sorted overlay copies (`convert.kernel_overlays`) of
    the whole tables and of each part of a 3-way split, whose rebased ids
    send columns outside the part to its spare column (sorted last)."""
    _, pt = decoders
    tb = pt.tables
    if pt.lm_mode == "rows":
        assert not any(k.startswith("tr_") for k in tb)
    _check_overlays(tb, "whole")
    for i, (_, part) in enumerate(pt.shard(["cpu"] * 3).tables["columns"]):
        nE = part["isfill_E"].shape[0]
        _check_overlays(part, f"part {i}")
        assert part["accept_bits"].shape == (1, nE)
        for k in ("tr_bg_cols", "tr_tg_cols"):
            if k in part and part[k].numel():
                assert int(part[k].max()) <= nE      # the spare column
    assert "tr_bg_cols" not in pt.shard(["cpu"] * 3).tables


@pytest.mark.parametrize("B,nE,K,want", [
    (8, 1868, 96, (2, 8)),          # 1.7k, mode rows
    (8, 20360, 96, (4, 1)),         # 20k, mode B
    (8, 128258, 96, (4, 1)),        # 126k, mode C
    (1, 20360, 20048, (4, 8)),      # K = W, B=1
    (1, 1868, 8, (4, 1)),           # too few exits to split
    (8, 1868, 16, (4, 2))])
def test_launch_shape(B, nE, K, want):
    """The kernel's default (columns per thread, exit splits) at the main
    path's shapes on an H100 (132 SMs), and every launch option's shared
    memory within a block's at en-us's 41 right contexts, one and two
    accept words."""
    assert tr.launch_shape(B, nE, K, 132) == want
    for mode in tr._MODES:
        for cpt in tr.COLS_PER_THREAD:
            for ks in tr.K_SPLITS:
                for nw in (1, 2):
                    assert tr._smem_bytes(mode, 128, 41, cpt, ks, nw) <= \
                        tr._SMEM_BYTES


def test_cpu_call_loads_no_library(decoders, monkeypatch):
    """The op on CPU tensors runs the plain version: no nvcc, no library,
    no launch counted; wrong exits are refused on any device."""
    _, pt = decoders

    def no_build(name):
        raise AssertionError(f"a CPU call loaded {name}")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    costs = torch.as_tensor(tie_costs(pt.am.n_sen, 8, seed=2))[None]
    args = chip_smoke.frame_exits(pt, costs)[0]
    n = _build.launches.get("transitions", 0)
    outs = tr.transitions(*args)
    assert _build.launches.get("transitions", 0) == n
    assert "transitions" not in _build._libs
    want = tr.transitions_ref(*args)
    for o, w in zip(outs, want):
        assert torch.equal(o, w)
    assert [o.dtype for o in outs] == [torch.float32, torch.int64,
                                       torch.int64, torch.int32, torch.int32,
                                       torch.int32, torch.int64]
    tb, lm, kv, ki, ctx_k, fb_k, svk, wpen = args
    with pytest.raises(TypeError):
        tr.transitions(tb, lm, kv, ki.to(torch.int32), ctx_k, fb_k, svk,
                       wpen)
    with pytest.raises(ValueError):
        tr.transitions(tb, lm, kv, ki, ctx_k, fb_k, svk[:, :, :-1], wpen)


def test_out_fills_given_tensors(decoders):
    """With `out=` the op writes its seven outputs into the given
    [B, nE] tensors and returns them, equal to the allocating call, on a
    real frame's exits and on tied ones, for the whole tables and for
    each part of a 2-way split; `out` of another shape, dtype or layout
    is refused."""
    _, pt = decoders
    costs = torch.as_tensor(tie_costs(pt.am.n_sen, 2 * pt.CHUNK, seed=12,
                                      tie_frame=2 * pt.CHUNK - 1))
    real = chip_smoke.frame_exits(pt, torch.stack([costs, costs.flip(0)]))[0]
    tables = [pt.tables] + [tb for _, tb in pt.shard(["cpu"] * 2)
                            .tables["columns"]]
    B = real[2].shape[0]
    for args in (real, chip_smoke.tie_exits(real, np.random.default_rng(5))):
        for tb in tables:
            nE = tb["isfill_E"].shape[0]
            want = tr.transitions(tb, *args[1:])
            for op in (tr.transitions, tr.transitions_ref):
                out = tr.outputs(B, nE, "cpu")
                got = op(tb, *args[1:], out=out)
                assert all(g is o for g, o in zip(got, out, strict=True))
                for o, w in zip(out, want, strict=True):
                    assert o.dtype == w.dtype and torch.equal(o, w)
    tb = pt.tables
    nE = tb["isfill_E"].shape[0]
    bad = list(tr.outputs(B, nE, "cpu"))
    for i, x in ((0, torch.empty((B, nE), dtype=torch.float64)),
                 (3, torch.empty((B, nE + 1), dtype=torch.int32)),
                 (6, torch.empty((nE, B), dtype=torch.int64).t())):
        with pytest.raises(ValueError, match=f"out\\[{i}\\]"):
            tr.transitions(tb, *real[1:], out=bad[:i] + [x] + bad[i + 1:])
    with pytest.raises(ValueError, match="6 tensors"):
        tr.transitions(tb, *real[1:], out=bad[:6])
