"""Streaming: the port's host frontend and feature streams, and its
masked streaming scan.

  * `FrontendStream` / `FeatStream` over 23 PCM chunks equal the port's
    whole-utterance host path (`MelFrontend.process` +
    `compute_feats_typed`) bit for bit, and the JAX package's stream
    classes bit for bit (float64 host code on both sides), for CMN
    live, batch and none.  A stream applies live CMN under 'batch' too
    (the reference's live path), so that case is held to the
    whole-utterance path with live CMN.
  * `with_carry` in 32-frame blocks, the last one padded and masked,
    gives records bit-equal to the whole-utterance `scan` and to the JAX
    `_make_scan(mask_carry=True).with_carry` fed the same costs, at B=1,
    with a block of mass ties and a last block shorter than 16 frames."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pocketsphinx_tpu.frontend import feat as jfeat
from pocketsphinx_tpu.frontend import stream as jstream
from pocketsphinx_tpu.frontend.mfcc import MelFrontend as JaxFrontend
from pocketsphinx_tpu_torch.frontend import feat as pfeat
from pocketsphinx_tpu_torch.frontend import stream as pstream
from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import jax_decoder, torch_one_thread  # noqa: F401

CFG = dict(nfilt=25, lowerf=130, upperf=6800, transform="dct",
           lifter_val=22, remove_noise=True)        # en-us feat.params
SV = "0-12/13-25/26-38"
FULL = "escore etf etgt ecx entry eprw erw1 erw2 m nviol".split()


@pytest.fixture(scope="module")
def pcm():
    return synth.make_pcm(41, 2.3)


def _stream(mod, fe, pcm, cmn, cmn_state):
    fs = mod.FrontendStream(fe)
    fst = mod.FeatStream(feat_type="1s_c_d_dd", svspec=SV, cmn=cmn,
                         cmn_state=cmn_state)
    chunks = np.array_split(pcm, 23)
    ceps, feats = [], []
    for i, c in enumerate(chunks):
        end = i == len(chunks) - 1
        cep = fs.process(c, end=end)
        ceps.append(cep)
        feats.append(fst.process(cep, end=end))
    return np.concatenate(ceps), np.concatenate(feats)


def test_frontend_host_path_equals_jax(pcm):
    cep = MelFrontend(**CFG).process(pcm)
    np.testing.assert_array_equal(cep, JaxFrontend(**CFG).process(pcm))
    for cmn in ("live", "batch", "none"):
        a, la = pfeat.compute_feats_typed(cep, svspec=SV, cmn=cmn,
                                          cmn_state=pfeat.CmnLive(13))
        b, lb = jfeat.compute_feats_typed(cep, svspec=SV, cmn=cmn,
                                          cmn_state=jfeat.CmnLive(13))
        np.testing.assert_array_equal(a, b)
        assert la == lb == [13, 13, 13]
        np.testing.assert_array_equal(
            pfeat.compute_feats_host(cep, cmn=cmn,
                                     cmn_state=pfeat.CmnLive(13)),
            jfeat.compute_feats(cep, cmn=cmn, cmn_state=jfeat.CmnLive(13)))


@pytest.mark.parametrize("cmn", ["live", "batch", "none"])
def test_streams_bit_exact(pcm, cmn):
    fe, jfe = MelFrontend(**CFG), JaxFrontend(**CFG)
    cep, feats = _stream(pstream, fe, pcm, cmn, pfeat.CmnLive(13))
    jcep, jfeats = _stream(jstream, jfe, pcm, cmn, jfeat.CmnLive(13))
    whole = fe.process(pcm)
    np.testing.assert_array_equal(cep, whole)
    np.testing.assert_array_equal(cep, jcep)
    ref, _ = pfeat.compute_feats_typed(
        whole, svspec=SV, cmn="none" if cmn == "none" else "live",
        cmn_state=pfeat.CmnLive(13))
    assert feats.shape == ref.shape == (len(whole), 3, 13)
    np.testing.assert_array_equal(feats, ref)
    np.testing.assert_array_equal(feats, jfeats)


def test_cmn_live_state_equal(pcm):
    cep = MelFrontend(**CFG).process(pcm)
    p, j = pfeat.CmnLive(13), jfeat.CmnLive(13)
    p.set_repr("40,3,-1")
    j.set_repr("40,3,-1")
    for _ in range(4):                  # past the 800-frame update
        np.testing.assert_array_equal(p(cep), j(cep))
    assert p.repr_string() == j.repr_string()
    np.testing.assert_array_equal(p.mean, j.mean)


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stream"))
    dic = d + "/small.dic"
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=4)
    lmf = synth.write_arpa(words, d + "/small.arpa", seed=5)
    spec = synth.make_model([dic], seed=6, n_sen=126 + 300, n_density=8)
    return (jax_decoder(spec, d, dic, lmf, topk=8),
            synth.build_decoder(spec, d, dic, lmf, topk=8, device="cpu"))


def test_with_carry_blocks_equal_whole_scan_and_jax(decoders):
    jx, pt = decoders
    T, BL = 75, 32                      # blocks of 32, 32 and 11 frames
    costs = np.random.default_rng(7).uniform(
        0, 400, (T, pt.am.n_sen)).astype(np.float32)
    costs[40:48] = 1e29                 # mass ties inside the second block
    whole = pt.scan(torch.as_tensor(costs)[None],
                    torch.ones((1, T), dtype=torch.bool))
    jscan = jx._make_scan(mask_carry=True)
    carry = jcarry = None
    got, jgot = [], []
    for b0 in range(0, T, BL):
        n = min(BL, T - b0)
        blk = np.zeros((BL, costs.shape[1]), np.float32)
        blk[:n] = costs[b0:b0 + n]
        valid = np.arange(BL) < n
        recs, carry = pt.with_carry(torch.as_tensor(blk)[None],
                                    torch.as_tensor(valid)[None], carry, b0)
        got.append([r[0, :n].numpy() for r in recs])
        jrecs, jcarry = jscan.with_carry(jnp.asarray(blk),
                                         jnp.asarray(valid), jcarry, b0)
        jgot.append([np.asarray(r)[:n] for r in jrecs])
    for k, name in enumerate(FULL):
        a = np.concatenate([g[k] for g in got])
        np.testing.assert_array_equal(a, whole[k][0, :T].numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(a, np.concatenate([g[k] for g in jgot]),
                                      err_msg=name)
    # the carry after the padded block equals the carry after T frames
    # of the whole scan: one more frame steps both alike
    nxt = np.random.default_rng(8).uniform(0, 400, (1, 1, costs.shape[1]))
    nxt = torch.as_tensor(nxt.astype(np.float32))
    r1, _ = pt.with_carry(nxt, torch.ones((1, 1), dtype=torch.bool), carry, T)
    all_costs = torch.cat([torch.as_tensor(costs)[None], nxt], 1)
    r2 = pt.scan(all_costs, torch.ones((1, T + 1), dtype=torch.bool))
    for a, b in zip(r1, r2):
        assert torch.equal(a[0, 0], b[0, T])


def _row_carry(pt, carry, B, b):
    """Row b of a B-utterance carry: every field of every chain bucket
    (through the flat carry's per-bucket views) and of the finals."""
    ch, ci = pt._chain_views(carry["chain"], B)
    return ([e[k][b] for e in ch + ci for k in sorted(e)]
            + [carry[n][k][b] for n in ("fin", "sp") if carry[n] is not None
               for k in ("S", "TF", "CTX")])


def test_with_carry_batch_rows_masked_apart(decoders):
    """At B=2 the rows' valid lengths differ inside a block: row 0 runs
    96 frames (a tie block in its middle block), row 1 ends 16 frames
    into the middle block and is padded from there.  Each row's records
    and carry equal that row's own whole scan and the JAX `with_carry`
    run on that row alone; the flat chain carry is bucket-major, so a
    mask that took its leading axis for the batch would mix the rows."""
    jx, pt = decoders
    T, BL, lens = 96, 32, (96, 48)
    rng = np.random.default_rng(12)
    costs = rng.uniform(0, 400, (2, T, pt.am.n_sen)).astype(np.float32)
    costs[0, 40:46] = 1e29
    valid = np.arange(T)[None, :] < np.array(lens)[:, None]
    carry, got = None, []
    for b0 in range(0, T, BL):
        recs, carry = pt.with_carry(torch.as_tensor(costs[:, b0:b0 + BL]),
                                    torch.as_tensor(valid[:, b0:b0 + BL]),
                                    carry, b0)
        got.append(recs)
    jscan = jx._make_scan(mask_carry=True)
    for b, n in enumerate(lens):
        whole, wcarry = pt._scan(torch.as_tensor(costs[b:b + 1, :n]),
                                 torch.ones((1, n), dtype=torch.bool), False)
        jcarry, jgot = None, []
        for b0 in range(0, T, BL):
            jrecs, jcarry = jscan.with_carry(jnp.asarray(costs[b, b0:b0 + BL]),
                                             jnp.asarray(valid[b, b0:b0 + BL]),
                                             jcarry, b0)
            jgot.append(jrecs)
        for k, name in enumerate(FULL):
            a = torch.cat([g[k][b] for g in got])[:n].numpy()
            np.testing.assert_array_equal(a, whole[k][0].numpy(),
                                          err_msg=f"row {b} {name}")
            np.testing.assert_array_equal(
                a, np.concatenate([np.asarray(g[k]) for g in jgot])[:n],
                err_msg=f"row {b} {name}")
        for x, y in zip(_row_carry(pt, carry, 2, b),
                        _row_carry(pt, wcarry, 1, 0)):
            assert torch.equal(x, y), f"row {b} carry"


def test_host_backtrace_equals_jax(decoders):
    jx, pt = decoders
    costs = np.random.default_rng(9).uniform(
        0, 400, (60, pt.am.n_sen)).astype(np.float32)
    jx.decode(None, costs=costs)
    pt.decode(None, costs=costs)
    for T in (60, 41, 17):
        hj, sj = jx._backtrace(jx.raw_records, T)
        hp, sp = pt._backtrace(pt.raw_records, T)
        assert (hp, [(s.word, s.start, s.end) for s in sp]) == \
            (hj, [(s.word, s.start, s.end) for s in sj])
