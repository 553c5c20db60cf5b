"""The port's plain chain step (pocketsphinx_tpu_torch.ops.chain.
chain_step_ref, which the grouped step runs per bucket for CPU tensors)
is bit-equal to the JAX package's Pallas chain kernel run in interpret
mode, with and without variants, batched; its folded per-diphone gather (`fd_idx`)
equals the JAX scan's one-hot expansion of the variant planes.  The
grouped step over a mixed bucket list (`chain_group_step`, one launch per
frame on the card) equals the Pallas kernel run bucket by bucket, and the
bucket table that the kernel reads puts every bucket's planes, tables and
exit rows where the plain version and the decoder put them, and every
bucket's senone ids where the kernel reads them.  The grouped step reads
each node's cost by its id from the frame's cost row (also a strided
view of a [B, CH, n_sen] chunk), bit-equal to the step on costs
pre-gathered per bucket.  The grouped step with offsets `m_prev` (the
scan's deferred renormalization) is the step on the carry less
`m_prev`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from pocketsphinx_tpu.ops.pallas_chain import chain_step as jax_chain_step
from pocketsphinx_tpu_torch.ops import chain
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import torch_one_thread  # noqa: F401

B = 3
NEG_INF = -1e30


def _mk(rng, NST, D, W, RF, NFD):
    return dict(
        S=(rng.standard_normal((B, NST, D, W)) * 30).astype(np.float32),
        TF=rng.integers(0, 99, (B, NST, D, W)).astype(np.int32),
        CTX=rng.integers(0, 999, (B, NST, D, W)).astype(np.int32),
        VAR=rng.integers(0, RF, (B, NST, W)).astype(np.int32),
        pre=(rng.random((B, NST, D, W)) * 80).astype(np.float32),
        prevd=(rng.random((B, NST, RF, NFD)) * 80).astype(np.float32),
        fd_idx=rng.integers(0, NFD, W).astype(np.int32),
        tp=-(rng.random((NST * (NST + 1), D, W)) * 5).astype(np.float32),
        fm=np.arange(D)[:, None] == rng.integers(0, D, W)[None, :],
        nv=rng.integers(1, RF + 1, W).astype(np.int32))


def _by_id(a):
    """`a` with a cost row that holds its pre and prevd costs end to end
    and the senone ids that select them (`chip_smoke.chain_inputs`'s
    keys)."""
    B = a["pre"].shape[0]
    parts = [a["pre"]] + ([a["prevd"]] if a["VAR"] is not None else [])
    costs = np.concatenate([x.reshape(B, -1) for x in parts], 1)
    ids = np.arange(costs.shape[1], dtype=np.int32)
    n = a["pre"][0].size
    return dict(a, costs=costs, senid=ids[:n].reshape(a["pre"].shape[1:]),
                senid_first_d=(ids[n:].reshape(a["prevd"].shape[1:])
                               if a["VAR"] is not None else None))


def _one_bucket(a, pip=float(np.float32(-0.7))):
    """`a` (a `_mk` dict, VAR None without variants) as a one-bucket
    group through `chain_group_step`, with `chain_step_ref`'s results:
    the [B, NST, D, W] planes, VAR [B, NST, W] and the exit rows."""
    has_var = a["VAR"] is not None
    grp, args = chip_smoke.chain_group_args([_by_id(dict(a, pip=pip))],
                                            "cpu")
    o = chain.chain_group_step(grp, **args)
    B, NST, D, W = a["S"].shape
    nVAR = (o[3].view(B, NST, W) if has_var
            else torch.zeros((B, NST, W), dtype=torch.int32))
    return ([x.view(B, NST, D, W) for x in o[:3]] + [nVAR]
            + list(o[4:7] if has_var else o[7:10]))


def _jax(a, has_var, prevd_w):
    """The Pallas kernel under vmap over the batch (interpret mode)."""
    pip = np.float32(-0.7)
    fn = lambda s, tf, cx, vr, pr, pv: jax_chain_step(  # noqa: E731
        s, tf, cx, vr if has_var else None, pr, pv if has_var else None,
        jnp.asarray(a["tp"]), jnp.asarray(a["fm"]), jnp.asarray(a["nv"]),
        pip, interpret=True)
    return jax.vmap(fn)(*[jnp.asarray(x) for x in
                          (a["S"], a["TF"], a["CTX"], a["VAR"], a["pre"],
                           prevd_w)])


@pytest.mark.parametrize("NST,D,W,RF", [(3, 6, 200, 4), (5, 3, 130, 2)])
@pytest.mark.parametrize("has_var", [True, False])
def test_chain_step_ref_matches_pallas(NST, D, W, RF, has_var):
    a = _mk(np.random.default_rng(7 + NST), NST, D, W, RF, NFD=W)
    a["fd_idx"] = np.arange(W, dtype=np.int32)     # per-word variant planes
    ref = _jax(a, has_var, a["prevd"])
    if not has_var:
        a = dict(a, VAR=None, prevd=None, fd_idx=None, nv=None)
    got = _one_bucket(a)
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                      err_msg=f"output {i}")


def test_chain_fd_idx_gather_equals_jax_expansion():
    """prevd per first diphone [B, NST, RF, NFD] gathered by fd_idx ==
    the JAX scan's oh_matmul("jvf,fw->jvw", prev_d, fd_oh) expansion
    (search/ngram_fused.py, chain block) feeding the Pallas kernel."""
    NST, D, W, RF, NFD = 3, 5, 170, 3, 23
    a = _mk(np.random.default_rng(3), NST, D, W, RF, NFD)
    fd_oh = (a["fd_idx"][None, :] == np.arange(NFD)[:, None]).astype(
        np.float32)
    prevd_w = jax.vmap(lambda p: jnp.einsum(
        "jvf,fw->jvw", p, jnp.asarray(fd_oh),
        precision=jax.lax.Precision.HIGHEST))(jnp.asarray(a["prevd"]))
    ref = _jax(a, True, prevd_w)
    got = _one_bucket(a)
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                      err_msg=f"output {i}")


def test_chain_step_refuses_batched_tables():
    a = _mk(np.random.default_rng(4), 3, 4, 50, 2, 9)
    a["tp"] = np.ascontiguousarray(np.broadcast_to(a["tp"],
                                                   (B,) + a["tp"].shape))
    with pytest.raises(ValueError, match="tp"):
        _one_bucket(a)


def _jax_bucket(p):
    """The Pallas kernel on one bucket of chip_smoke.chain_inputs, under
    vmap over the batch (interpret mode); the per-diphone variant planes
    expanded to words by fd_idx."""
    has_var = p["VAR"] is not None
    B, NST, D, W = p["S"].shape
    var = p["VAR"] if has_var else np.zeros((B, NST, W), np.int32)
    prevd = (p["prevd"][..., p["fd_idx"]] if has_var
             else np.zeros((B, NST, 1, W), np.float32))
    nv = p["nv"] if has_var else np.ones(W, np.int32)
    fn = lambda s, tf, cx, vr, pr, pv: jax_chain_step(  # noqa: E731
        s, tf, cx, vr if has_var else None, pr, pv if has_var else None,
        jnp.asarray(p["tp"]), jnp.asarray(p["fm"]), jnp.asarray(nv),
        p["pip"], interpret=True)
    return [np.asarray(x) for x in jax.vmap(fn)(*[jnp.asarray(x) for x in (
        p["S"], p["TF"], p["CTX"], var, p["pre"], prevd)])]


# (NST, D, W, RF, NFD, has_var) per bucket, in layout order: variant
# buckets of several depths, then a CI bucket
GROUPS = {3: [(3, 5, 70, 4, 9, True), (3, 8, 40, 3, 7, True),
              (3, 3, 9, 0, 0, False)],
          5: [(5, 3, 50, 2, 6, True), (5, 6, 20, 3, 4, True),
              (5, 4, 7, 0, 0, False)]}


def _row(grp, k):
    """Bucket k's row of the table the kernel reads, by column name."""
    r = grp.tab[grp.order.index(k)].tolist()
    return dict(zip(chain.TAB_COLUMNS, r))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("NST", [3, 5])
def test_chain_group_matches_pallas_per_bucket(NST, ties):
    rng = np.random.default_rng(20 + NST)
    costs = chip_smoke.chain_costs(rng, B, 300)
    per = [chip_smoke.chain_inputs(rng, B, *bk, ties, costs)
           for bk in GROUPS[NST]]
    grp, args = chip_smoke.chain_group_args(per, "cpu")
    out = chain.chain_group_step(grp, **args)
    planes = [grp.planes(x, B) for x in out[:3]]
    var_planes = iter(grp.var_planes(out[3], B))
    for k, p in enumerate(per):
        ref = _jax_bucket(p)
        r = _row(grp, k)
        ex = out[4:7] if r["has_var"] else out[7:10]
        got = [x[k] for x in planes]
        got.append(next(var_planes) if r["has_var"] else
                   np.zeros_like(ref[3]))
        got += [x[:, r["xcol"]:r["xcol"] + r["W"]] for x in ex]
        for i, (a, g) in enumerate(zip(ref, got)):
            np.testing.assert_array_equal(np.asarray(g), a,
                                          err_msg=f"bucket {k} output {i}")


@pytest.mark.parametrize("offsets", ["zero", "large", "mixed"])
@pytest.mark.parametrize("NST", [3, 5])
def test_chain_group_m_prev_is_the_subtraction_first(NST, offsets):
    """The grouped step with `m_prev` (the scan's deferred
    renormalization) is every bucket's `S - m_prev` followed by the step
    without it, bit for bit, over variant and CI buckets whose carry
    holds dead (NEG_INF) scores and the <s> entry's 0.0; an offset of 0
    gives the step without one."""
    per = [chip_smoke.chain_inputs(np.random.default_rng(30 + NST), 4, *bk,
                                   True) for bk in GROUPS[NST]]
    for p in per:
        p["S"][:, :, 0, ::3] = NEG_INF
    per[-1]["S"][:, 0, 1, 2] = 0.0               # <s> at its first node
    grp, args = chip_smoke.chain_group_args(per, "cpu")
    m = torch.as_tensor(chip_smoke.m_prev_inputs(np.random.default_rng(6),
                                                 4, offsets))
    got = chain.chain_group_step(grp, **args, m_prev=m)
    S = args["S"].clone()
    for v in grp.planes(S, 4):
        v.sub_(m[:, None, None, None])
    want = chain.chain_group_step(grp, **dict(args, S=S))
    for x, y in zip(got, want, strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    plain = chain.chain_group_step(grp, **args)
    assert torch.equal(got[0], plain[0]) == (offsets == "zero")


def test_chain_group_table_puts_buckets_at_their_offsets():
    """Each bucket's carry, VAR, senone ids (senid, senid_first_d), tp,
    fm, nv, fd_idx and exit row sit where the kernel's arithmetic on its
    table row looks for them, and the costs those ids select from the
    cost row are the bucket's pre and prevd; the rows are deepest first
    with contiguous block ranges."""
    spec = [(3, 5, 70, 4, 9, True), (3, 16, 40, 3, 7, True),
            (3, 3, 9, 0, 0, False), (3, 8, 33, 2, 5, True),
            (3, 2, 3, 0, 0, False)]
    Bt, N = 2, 3
    rng = np.random.default_rng(11)
    costs = chip_smoke.chain_costs(rng, Bt, 97)
    per = [chip_smoke.chain_inputs(rng, Bt, *s, False, costs) for s in spec]
    grp, args = chip_smoke.chain_group_args(per, "cpu")
    rows = [dict(zip(chain.TAB_COLUMNS, r)) for r in grp.tab.tolist()]
    Ds = [r["D"] for r in rows]
    assert Ds == sorted(Ds, reverse=True)
    nblk = [-(-r["W"] // chain.WT) for r in rows]
    assert [r["blk0"] for r in rows] == list(np.cumsum(nblk) - nblk)
    assert grp.n_blocks == sum(nblk)
    assert grp.sid.dtype == torch.int32 and grp.n_sen <= 97
    S, VAR, cost = (args[k].numpy() for k in ("S", "VAR", "costs"))
    tp, fm, nv, fdi, sid = (x.numpy() for x in (grp.tp, grp.fm, grp.nv,
                                                grp.fd_idx, grp.sid))
    out = chain.chain_group_step(grp, **args)
    xcol = [0, 0]
    for k, p in enumerate(per):
        r = _row(grp, k)
        D, W, v = r["D"], r["W"], r["has_var"]
        b, j, d, w = np.indices((Bt, N, D, W))
        np.testing.assert_array_equal(
            S[Bt * r["carry"] + ((b * N + j) * D + d) * W + w], p["S"])
        np.testing.assert_array_equal(grp.planes(args["S"], Bt)[k], p["S"])
        j1, d1, w1 = np.indices((N, D, W))
        ids = sid[r["sid"] + (j1 * D + d1) * W + w1]
        np.testing.assert_array_equal(ids, p["senid"])
        np.testing.assert_array_equal(cost[:, ids], p["pre"])
        a, d2, w2 = np.indices((N * (N + 1), D, W))
        np.testing.assert_array_equal(tp[r["tp"] + (a * D + d2) * W + w2],
                                      p["tp"])
        d1, w1 = np.indices((D, W))
        np.testing.assert_array_equal(fm[r["fm"] + d1 * W + w1], p["fm"])
        if v:
            b3, j3, w3 = np.indices((Bt, N, W))
            np.testing.assert_array_equal(
                VAR[Bt * r["var"] + (b3 * N + j3) * W + w3], p["VAR"])
            RF, NFD = r["RF"], r["NFD"]
            j4, v4, f4 = np.indices((N, RF, NFD))
            ids = sid[r["sfd"] + (j4 * RF + v4) * NFD + f4]
            np.testing.assert_array_equal(ids, p["senid_first_d"])
            np.testing.assert_array_equal(cost[:, ids], p["prevd"])
            np.testing.assert_array_equal(nv[r["woff"] + np.arange(W)],
                                          p["nv"])
            np.testing.assert_array_equal(fdi[r["woff"] + np.arange(W)],
                                          p["fd_idx"])
        assert r["xcol"] == xcol[not v]
        xcol[not v] += W
        ref = chain.chain_step_ref(**{n: (torch.as_tensor(x) if isinstance(
            x, np.ndarray) else x) for n, x in p.items()
            if n not in ("costs", "senid", "senid_first_d")})
        ex = out[4:7] if v else out[7:10]
        for e, rr in zip(ex, ref[4:]):
            np.testing.assert_array_equal(e[:, r["xcol"]:r["xcol"] + W], rr)
    assert tuple(xcol) == grp.n_exit


@pytest.mark.parametrize("frame", [None, (16, 5)], ids=["row", "chunk_view"])
@pytest.mark.parametrize("Bn", [1, 3, 8])
@pytest.mark.parametrize("NST", [3, 5])
def test_chain_group_by_id_equals_pregathered(NST, Bn, frame):
    """The grouped step that reads each node's cost by its senone id
    from the frame's cost row (as it is, or frame 5 of a [B, 16, n_sen]
    chunk: a strided view, the other frames NaN) is bit-equal to the
    plain step of each bucket on its costs pre-gathered by the same ids
    (the scan's path before the kernel read them), over variant buckets
    of several depths and a CI bucket, with ids shared between nodes."""
    rng = np.random.default_rng(40 + NST + Bn)
    costs = chip_smoke.chain_costs(rng, Bn, 61)
    per = [chip_smoke.chain_inputs(rng, Bn, *bk, True, costs)
           for bk in GROUPS[NST]]
    grp, args = chip_smoke.chain_group_args(per, "cpu", frame=frame)
    if frame is not None:
        assert args["costs"].stride() == (frame[0] * 61, 1)
    m = torch.as_tensor(chip_smoke.m_prev_inputs(rng, Bn, "mixed"))
    got = chain.chain_group_step(grp, **args, m_prev=m)
    S = args["S"].clone()
    for v in grp.planes(S, Bn):
        v.sub_(m[:, None, None, None])
    planes = [grp.planes(x, Bn) for x in (S, args["TF"], args["CTX"])]
    var_planes = iter(grp.var_planes(args["VAR"], Bn))
    ex = ([], [])
    for k, p in enumerate(per):
        has_var = p["VAR"] is not None
        t = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
        ref = chain.chain_step_ref(
            planes[0][k], planes[1][k], planes[2][k],
            next(var_planes) if has_var else None,
            t(costs[:, p["senid"]]),
            t(costs[:, p["senid_first_d"]]) if has_var else None,
            t(p["fd_idx"]), t(p["tp"]), t(p["fm"]), t(p["nv"]), p["pip"])
        for i in range(3):
            assert torch.equal(grp.planes(got[i], Bn)[k], ref[i])
        if has_var:
            assert torch.equal(grp.var_planes(got[3], Bn)[k], ref[3])
        ex[not has_var].append(ref[4:])
    for g, x in zip((got[4:7], got[7:10]), ex):
        for i in range(3):
            assert torch.equal(g[i], torch.cat([e[i] for e in x], 1))


def test_chain_group_refuses_costs_it_cannot_read():
    """The cost row must reach every id of the group and hold its
    senones at unit stride; its rows may lie at any stride."""
    rng = np.random.default_rng(9)
    per = [chip_smoke.chain_inputs(rng, 2, *bk, False,
                                   chip_smoke.chain_costs(rng, 2, 50))
           for bk in GROUPS[3]]
    grp, args = chip_smoke.chain_group_args(per, "cpu")
    n = args["costs"].shape[1]
    assert grp.n_sen <= n
    with pytest.raises(ValueError, match="senones"):
        chain.chain_group_step(grp, **dict(
            args, costs=args["costs"][:, :grp.n_sen - 1]))
    wide = torch.zeros((2, n, 2))
    wide[:, :, 0] = args["costs"]
    with pytest.raises(ValueError, match="unit stride"):
        chain.chain_group_step(grp, **dict(args, costs=wide[:, :, 0]))
    padded = torch.zeros((2, n + 7))
    padded[:, :n] = args["costs"]
    got = chain.chain_group_step(grp, **dict(args, costs=padded[:, :n]))
    want = chain.chain_group_step(grp, **args)
    for x, y in zip(got, want, strict=True):
        assert torch.equal(x, y)


def test_decoder_chain_group_layout(tmp_path):
    """In the decoder's group, the chain buckets' exit rows sit at their
    words' offsets (w_lo in the multi-phone words, w_lo - n_multi -
    n_single in the CI words), each bucket's senone ids at its sid and
    sfd offsets are its senid and senid_first_d, and the per-chunk
    pre-gather holds the finals' and single-phone columns' ids alone."""
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, seed=0)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=3)
    spec = synth.make_model([dic], seed=1, n_sen=126 + 300, n_density=4)
    dec = synth.build_decoder(spec, str(tmp_path), dic, lmf, topk=8,
                              depth_buckets=(1, 2, 3, 8), device="cpu")
    grp = dec.tables["chain"]
    assert len(dec.chains) >= 3 and dec.ci_chains
    assert grp.n_buckets == len(dec.chains) + len(dec.ci_chains)
    assert set(dec.tables["gather"]) <= {"fin", "sp"}
    assert "fin" in dec.tables["gather"]
    for name, (ids, shape) in dec.tables["gather"].items():
        assert ids.dtype == torch.int64 and (ids.numel(),) == (
            int(np.prod(shape)),)
    assert grp.sid.dtype == torch.int32
    assert grp.n_sen <= dec.am.n_sen
    sid = grp.sid.numpy()
    ci0 = dec.n_multi + dec.n_single
    for k, ch in enumerate(dec.chains + dec.ci_chains):
        r = _row(grp, k)
        assert (r["D"], r["W"], r["has_var"]) == (ch.D, ch.Wb,
                                                  int(k < len(dec.chains)))
        assert r["xcol"] == (ch.w_lo if r["has_var"] else ch.w_lo - ci0)
        np.testing.assert_array_equal(sid[r["sid"]:r["sid"] + ch.senid.size],
                                      ch.senid.reshape(-1))
        if r["has_var"]:
            sf = ch.senid_first_d
            assert (r["RF"], r["NFD"]) == sf.shape[1:]
            np.testing.assert_array_equal(
                sid[r["sfd"]:r["sfd"] + sf.size], sf.reshape(-1))
    assert grp.n_exit == (dec.n_multi, dec.W - ci0)
