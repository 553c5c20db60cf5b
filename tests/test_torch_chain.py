"""The port's plain chain step (pocketsphinx_tpu_torch.ops.chain.
chain_step_ref, which the grouped step runs per bucket for CPU tensors)
is bit-equal to the JAX package's Pallas chain kernel run in interpret
mode, with and without variants, batched; its folded per-diphone gather (`fd_idx`)
equals the JAX scan's one-hot expansion of the variant planes.  The
grouped step over a mixed bucket list (`chain_group_step`, one launch per
frame on the card) equals the Pallas kernel run bucket by bucket, and the
bucket table that the kernel reads puts every bucket's planes, tables and
exit rows where the plain version and the decoder put them.  The grouped
step with offsets `m_prev` (the scan's deferred renormalization) is the
step on the carry less `m_prev`."""

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


def _one_bucket(a, pip=float(np.float32(-0.7))):
    """`a` (a `_mk` dict, VAR None without variants) as a one-bucket
    group through `chain_group_step`, with `chain_step_ref`'s results:
    the [B, NST, D, W] planes, VAR [B, NST, W] and the exit rows."""
    has_var = a["VAR"] is not None
    grp, args = chip_smoke.chain_group_args([dict(a, pip=pip)], "cpu")
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
    per = [chip_smoke.chain_inputs(np.random.default_rng(20 + NST), B, *bk,
                                   ties) for bk in GROUPS[NST]]
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
    """Each bucket's carry, VAR, pre, prevd, tp, fm, nv, fd_idx and exit
    row sit where the kernel's arithmetic on its table row looks for
    them; the rows are deepest first with contiguous block ranges."""
    spec = [(3, 5, 70, 4, 9, True), (3, 16, 40, 3, 7, True),
            (3, 3, 9, 0, 0, False), (3, 8, 33, 2, 5, True),
            (3, 2, 3, 0, 0, False)]
    Bt, N = 2, 3
    per = [chip_smoke.chain_inputs(np.random.default_rng(11), Bt, *s, False)
           for s in spec]
    grp, args = chip_smoke.chain_group_args(per, "cpu")
    rows = [dict(zip(chain.TAB_COLUMNS, r)) for r in grp.tab.tolist()]
    Ds = [r["D"] for r in rows]
    assert Ds == sorted(Ds, reverse=True)
    nblk = [-(-r["W"] // chain.WT) for r in rows]
    assert [r["blk0"] for r in rows] == list(np.cumsum(nblk) - nblk)
    assert grp.n_blocks == sum(nblk)
    S, VAR, g = (args[k].numpy() for k in ("S", "VAR", "g"))
    tp, fm, nv, fdi = (x.numpy() for x in (grp.tp, grp.fm, grp.nv,
                                           grp.fd_idx))
    out = chain.chain_group_step(grp, **args)
    xcol = [0, 0]
    for k, p in enumerate(per):
        r = _row(grp, k)
        D, W, v = r["D"], r["W"], r["has_var"]
        b, j, d, w = np.indices((Bt, N, D, W))
        np.testing.assert_array_equal(
            S[Bt * r["carry"] + ((b * N + j) * D + d) * W + w], p["S"])
        np.testing.assert_array_equal(grp.planes(args["S"], Bt)[k], p["S"])
        np.testing.assert_array_equal(
            g[b, r["pre"] + (j * D + d) * W + w], p["pre"])
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
            b4, j4, v4, f4 = np.indices((Bt, N, RF, NFD))
            np.testing.assert_array_equal(
                g[b4, r["prevd"] + (j4 * RF + v4) * NFD + f4], p["prevd"])
            np.testing.assert_array_equal(nv[r["woff"] + np.arange(W)],
                                          p["nv"])
            np.testing.assert_array_equal(fdi[r["woff"] + np.arange(W)],
                                          p["fd_idx"])
        assert r["xcol"] == xcol[not v]
        xcol[not v] += W
        ref = chain.chain_step_ref(**{n: (torch.as_tensor(x) if isinstance(
            x, np.ndarray) else x) for n, x in p.items()})
        ex = out[4:7] if v else out[7:10]
        for e, rr in zip(ex, ref[4:]):
            np.testing.assert_array_equal(e[:, r["xcol"]:r["xcol"] + W], rr)
    assert tuple(xcol) == grp.n_exit


def test_decoder_chain_group_layout(tmp_path):
    """In the decoder's group, the chain buckets' exit rows sit at their
    words' offsets (w_lo in the multi-phone words, w_lo - n_multi -
    n_single in the CI words), and the g row's gather ids at each bucket's pre and
    prevd offsets are the bucket's senone ids."""
    dic = str(tmp_path / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, seed=0)
    lmf = synth.write_arpa(words, str(tmp_path / "small.arpa"), seed=3)
    spec = synth.make_model([dic], seed=1, n_sen=126 + 300, n_density=4)
    dec = synth.build_decoder(spec, str(tmp_path), dic, lmf, topk=8,
                              depth_buckets=(1, 2, 3, 8), device="cpu")
    grp = dec.tables["chain"]
    assert len(dec.chains) >= 3 and dec.ci_chains
    assert grp.n_buckets == len(dec.chains) + len(dec.ci_chains)
    ids, shape = dec.tables["gather"]["chain"]
    ids = ids.numpy()
    assert (ids.size,) == (grp.g_width,) == shape
    ci0 = dec.n_multi + dec.n_single
    for k, ch in enumerate(dec.chains + dec.ci_chains):
        r = _row(grp, k)
        assert (r["D"], r["W"], r["has_var"]) == (ch.D, ch.Wb,
                                                  int(k < len(dec.chains)))
        assert r["xcol"] == (ch.w_lo if r["has_var"] else ch.w_lo - ci0)
        np.testing.assert_array_equal(ids[r["pre"]:r["pre"] + ch.senid.size],
                                      ch.senid.reshape(-1))
        if r["has_var"]:
            sf = ch.senid_first_d
            np.testing.assert_array_equal(
                ids[r["prevd"]:r["prevd"] + sf.size], sf.reshape(-1))
    assert grp.n_exit == (dec.n_multi, dec.W - ci0)
