"""The port's plain fan step (pocketsphinx_tpu_torch.ops.fan.fan_step_ref,
which `fan_step` runs for CPU tensors) is bit-equal to the JAX package's
Pallas fan kernel run in interpret mode on the same padded fan carry
(`fan_step(..., n_real=Wm)`); batched inputs share lp/tp; the new carry's
pads are NEG_INF/0, the partial maxima give the max of the new scores
over the real words, and the exit plane goes into a strided view.  The
decoder keeps a padded fan carry with records equal to the JAX scan's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from _torch_jax_helpers import jax_decoder, torch_one_thread  # noqa: F401
from pocketsphinx_tpu.ops.pallas_fan import fan_step as jax_fan_step
from pocketsphinx_tpu_torch.ops import fan
from pocketsphinx_tpu_torch.testing import synth

NAMES = ["S", "TF", "CX", "out_f", "esc", "etf", "ecx"]
NEG_INF = -1e30
ARGS = ("S", "TF", "CX", "pred", "ptf", "pcx", "pre")

#: (NRC, Wm, LP): Wm % 4 = 1, 0, 3, 2; the last two under one block
SHAPES = [(11, 257, 37), (41, 640, 601), (41, 515, 601), (5, 258, 23),
          (3, 7, 5)]


def _mk(seed, B, NRC, W, LP, ties):
    # chip_smoke's inputs (tests/test_pallas_fan.py's style, padded)
    return chip_smoke.fan_inputs(np.random.default_rng(seed), B, NRC, W, LP,
                                 ties)


def _torch(a):
    return {k: torch.as_tensor(v) for k, v in a.items()}


def _jax(a, b, W):
    return jax_fan_step(*[jnp.asarray(a[k][b]) for k in ARGS],
                        jnp.asarray(a["lp"]), jnp.asarray(a["tp"]),
                        n_real=W, interpret=True)


def _assert_real_equal(ref, got, W):
    """JAX outputs (one batch element) == the port's real columns."""
    for i, (n, r, g) in enumerate(zip(NAMES, ref, got)):
        r = np.asarray(r)
        if i < 3:                  # JAX keeps its own tile padding
            r, g = r[..., :W], g[..., :W]
        np.testing.assert_array_equal(r, g.numpy(), err_msg=n)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ties", [False, True])
def test_fan_step_ref_matches_pallas(shape, ties):
    NRC, W, LP = shape
    a = _mk(7 if ties else 3, 1, NRC, W, LP, ties)
    got = fan.fan_step(**_torch(a))          # CPU tensors: the plain version
    _assert_real_equal(_jax(a, 0, W), [g[0] for g in got], W)


@pytest.mark.parametrize("shape", SHAPES)
def test_fan_step_pads_and_max(shape):
    """Random pads in the carry, lp and tp reach no result; the new
    carry's pads are NEG_INF scores and 0 payloads; mx's max is the max
    of the new scores over the real words."""
    NRC, W, LP = shape
    a = _torch(_mk(5, 2, NRC, W, LP, ties=False))
    nS, nTF, nCX, *_, mx = got = fan.fan_step(**a)
    Wp = fan.padded_width(W)
    assert nS.shape[-1] == Wp and Wp % 4 == 0 and Wp - W < 4
    assert bool((nS[..., W:] == NEG_INF).all())
    assert not nTF[..., W:].any() and not nCX[..., W:].any()
    assert torch.equal(mx.amax(dim=1), torch.amax(nS[..., :W], dim=(1, 2, 3)))
    # other pads (carry, tp; lp out of range already) give the same step
    for k, fill in (("S", 7.0), ("TF", 3), ("CX", 5), ("tp", 9.0)):
        a[k][..., W:] = fill
    for x, y in zip(got, fan.fan_step(**a)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", [(11, 257, 37), (3, 7, 5)])
def test_fan_step_out_f_view(shape):
    """The exit plane written into columns [3, 3 + Wm) of a wider buffer
    equals the one returned without a view; the other columns keep their
    values."""
    NRC, W, LP = shape
    a = _torch(_mk(9, 2, NRC, W, LP, ties=True))
    want = fan.fan_step(**a)
    buf = torch.full((2, NRC, W + 8), 2.5)
    got = fan.fan_step(**a, out_f=buf[:, :, 3:3 + W])
    assert got[3].data_ptr() == buf[:, :, 3:].data_ptr()
    assert torch.equal(buf[:, :, 3:3 + W], want[3])
    assert bool((buf[:, :, :3] == 2.5).all())
    assert bool((buf[:, :, 3 + W:] == 2.5).all())
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_fan_step_batched_shared_lp_tp():
    B, NRC, W, LP = 3, 9, 150, 23
    a = _mk(11, B, NRC, W, LP, ties=True)
    ref = jax.vmap(lambda *x: jax_fan_step(
        *x, jnp.asarray(a["lp"]), jnp.asarray(a["tp"]), n_real=W,
        interpret=True))(*[jnp.asarray(a[k]) for k in ARGS])
    got = fan.fan_step_ref(**_torch(a))
    _assert_real_equal(ref, got, W)


@pytest.mark.parametrize("key", ["lp", "tp"])
def test_fan_step_refuses_batched_lp_tp(key):
    a = _torch(_mk(1, 2, 5, 40, 7, ties=False))
    a[key] = a[key][None].expand(2, *a[key].shape).contiguous()
    with pytest.raises(ValueError, match=key):
        fan.fan_step(**a)


def test_fan_step_refuses_wrong_dtype_and_counts_nothing_on_cpu():
    a = _torch(_mk(2, 1, 5, 40, 7, ties=False))
    fan.reset_launches()
    fan.fan_step(**a)
    assert fan.launches == 0                 # the CPU runs the plain version
    a["TF"] = a["TF"].to(torch.int64)
    with pytest.raises(TypeError, match="TF"):
        fan.fan_step(**a)


@pytest.mark.parametrize("bad", ["unpadded", "wide", "out_f_shape",
                                 "out_f_stride", "groups"])
def test_fan_step_refuses_layouts_it_does_not_take(bad):
    a = _torch(_mk(4, 2, 5, 41, 7, ties=False))
    kw = {}
    if bad == "unpadded":                     # the carry at Wm columns
        for k in ("S", "TF", "CX"):
            a[k] = a[k][..., :41].contiguous()
    elif bad == "wide":                       # more than one pad's worth
        for k in ("S", "TF", "CX"):
            a[k] = torch.nn.functional.pad(a[k], (0, 4))
    elif bad == "out_f_shape":
        kw["out_f"] = torch.empty((2, 5, 44))
    elif bad == "out_f_stride":
        kw["out_f"] = torch.empty((2, 5, 82))[:, :, ::2]
    else:
        kw["groups"] = 3
    with pytest.raises(ValueError):
        fan.fan_step(**a, **kw)


def test_fan_groups_fill_the_card_within_shared_memory():
    # on an H100's 132 multiprocessors: 20k and 126k words at B=8, and
    # 20k at B=1, the shapes the card timed at each choice (chip_smoke)
    got = [fan._groups(B, fan.padded_width(W), 601, 132)
           for B, W in ((8, 20035), (8, 125973), (1, 20035))]
    assert got == [2, 1, 4]
    assert fan._groups(1, 8, 4000, 132) == 2      # 4 groups do not fit
    assert fan._groups(1, 8, 9000, 132) == 1      # only one group fits
    with pytest.raises(ValueError, match="LP"):
        fan._groups(1, 8, 10000, 132)


@pytest.fixture(scope="module")
def padded_task(tmp_path_factory):
    """A 3-state task whose n_multi (30) is no multiple of 4, so the fan
    carry has pad columns; the JAX decoder runs its Pallas fan in
    interpret mode on its own padded carry."""
    d = tmp_path_factory.mktemp("fanpad")
    dic = str(d / "small.dic")
    words = synth.small_dictionary(dic, n_words=30, n_single=3, seed=2)
    lmf = synth.write_arpa(words, str(d / "small.arpa"), seed=3)
    spec = synth.make_model([dic], seed=1, n_sen=126 + 300, n_density=8)
    mp = pytest.MonkeyPatch()
    mp.setenv("PS_PALLAS_FAN", "1")
    try:
        jx = jax_decoder(spec, str(d), dic, lmf, topk=8)
        for minimal in (False, True):            # read PS_PALLAS_FAN
            jx._make_scan(minimal=minimal)
    finally:
        mp.undo()
    pt = synth.build_decoder(spec, str(d), dic, lmf, topk=8, device="cpu")
    return jx, pt


def test_decoder_fan_carry_and_tables_padded(padded_task):
    _, pt = padded_task
    Wm, Wp = pt.n_multi, fan.padded_width(pt.n_multi)
    assert pt.NST == 3 and Wm % 4 and Wp > Wm
    c = pt.init_carry(2)["fin"]
    assert c["S"].shape == (2, 3, pt.n_rcp, Wp)
    assert bool((c["S"] == NEG_INF).all()) and not c["TF"].any()
    tb = pt.tables
    assert tb["lp_idx"].shape == (Wp,) and tb["tp_fin12"].shape == (12, Wp)
    np.testing.assert_array_equal(tb["lp_idx"][:Wm].numpy(),
                                  pt.host_tables["lp_idx"])
    np.testing.assert_array_equal(tb["tp_fin12"][:, :Wm].numpy(),
                                  pt.host_tables["tp_fin12"])
    assert pt.host_tables["lp_idx"].shape == (Wm,)


def test_decoder_padded_fan_records_equal_jax(padded_task):
    """Full records of a decode, and a B=2 minimal scan with a tie frame
    and unequal lengths, equal the JAX scan's (which runs its Pallas fan
    in interpret mode on its own tile-padded carry); the carry's pads
    stay dead through the scan."""
    jx, pt = padded_task
    from _torch_jax_helpers import assert_records_equal, tie_costs
    costs = tie_costs(pt.am.n_sen, 40, seed=5)
    hj, _ = jx.decode(None, costs=costs)
    hp, _ = pt.decode(None, costs=costs)
    assert_records_equal(pt.raw_records, jx.raw_records,
                         "escore etf etgt ecx entry eprw erw1 erw2 m "
                         "nviol".split())
    assert hp == hj
    c2 = np.stack([tie_costs(pt.am.n_sen, 40, seed=s) for s in (6, 7)])
    valid = np.arange(40)[None, :] < np.array([40, 23])[:, None]
    rj = jax.vmap(jx._make_scan(minimal=True))(jnp.asarray(c2),
                                               jnp.asarray(valid))
    rp, carry = pt._scan(torch.as_tensor(c2), torch.as_tensor(valid), True)
    assert_records_equal(rp, rj,
                         "kv ki etf etgt rank m nviol".split())
    Wm = pt.n_multi
    assert bool((carry["fin"]["S"][..., Wm:] < -1e29).all())
    assert not carry["fin"]["TF"][..., Wm:].any()
