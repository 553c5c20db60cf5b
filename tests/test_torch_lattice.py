"""The port's word lattice equals the JAX package's, from one record set
(the JAX decoder's `decode` on a given cost matrix):

  * the node and link lists, in order (the port finds the plausible
    exits on its device and numbers nodes and links with vectorized host
    code; the JAX lattice uses its C extension here), built from the
    JAX records and from the port decoder's own raw records on its
    device after decoding the same costs;
  * `bestpath` hyp, segments and score, `posterior`, `node_posterior`
    and `link_posterior`: the same float64 host arithmetic on the same
    inputs, so held exactly equal;
  * `nbest(5)` and `posterior_prune`;
  * `write` -> `read` and `write_htk` -> `read_htk`: the port writes the
    same bytes as the JAX package, and either package reads them back to
    the same lists."""

import numpy as np
import pytest

from pocketsphinx_tpu.search.lattice import Lattice as JaxLattice
from pocketsphinx_tpu_torch.search.lattice import Lattice, plausible_exits
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import jax_decoder, torch_one_thread  # noqa: F401

LWF = 9.5 / 6.5                          # bestpathlw / lw


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lattice"))
    dic = d + "/small.dic"
    words = synth.small_dictionary(dic, n_words=40, n_single=3, seed=0)
    lmf = synth.write_arpa(words, d + "/small.arpa", seed=3)
    spec = synth.make_model([dic], seed=1, n_sen=126 + 300, n_density=8)
    return (jax_decoder(spec, d, dic, lmf, topk=8),
            synth.build_decoder(spec, d, dic, lmf, topk=8, device="cpu"))


def _costs(n_sen, T, seed, ties):
    c = np.random.default_rng(seed).uniform(0, 400, (T, n_sen))
    if ties:
        c[T // 3:T // 3 + 4] = 1e29          # every score ties: mass exits
    return c.astype(np.float32)


@pytest.fixture(scope="module", params=[(60, 5, False), (90, 6, True)],
                ids=["T60", "T90-ties"])
def lattices(request, decoders):
    jx, pt = decoders
    T, seed, ties = request.param
    costs = _costs(pt.am.n_sen, T, seed, ties)
    jx.decode(None, costs=costs)
    pt.decode(None, costs=costs)
    return (JaxLattice.from_flat_records(jx),
            Lattice.from_flat_records(pt, records=jx.records),
            jx, pt)


def _nodes(lat):
    return [(n.word, n.base, n.sf, n.is_fill, n.id, n.entries, n.exits)
            for n in lat.nodes]


def _links(lat, post=False):
    return [(l.src, l.dst, l.ef, l.ascr)
            + ((l.alpha, l.beta, l.post) if post else ())
            for l in lat.links]


def test_node_and_link_lists_equal(lattices):
    jl, pl, _, _ = lattices
    assert pl.n_nodes > 10 and pl.n_links > 20
    assert _nodes(pl) == _nodes(jl)
    assert _links(pl) == _links(jl)
    assert (pl.start, pl.end, pl.n_frames) == (jl.start, jl.end, jl.n_frames)


def test_lattice_from_device_records_equal(lattices):
    jl, _, _, pt = lattices
    lat = Lattice.from_flat_records(pt)         # pt's raw records
    assert _nodes(lat) == _nodes(jl)
    assert _links(lat) == _links(jl)


def test_plausible_exits_in_tw_order(lattices):
    _, _, jx, _ = lattices
    escore, estf = jx.records[0], jx.records[1]
    t, w, sf = plausible_exits(escore, estf, -112.4, "cpu")
    assert len(t) and np.all(np.diff(t * escore.shape[1] + w) > 0)
    assert np.all((sf >= 0) & (sf <= t))
    best = escore.max(axis=1)
    assert np.all(escore[t, w] >= best[t] + np.float32(-112.4))


def test_bestpath_and_posteriors_equal(lattices):
    jl, pl, jx, pt = lattices
    fin = pt.dict.wordstr(pt.words[pt.finish_idx])
    kw = dict(lwf=LWF, silpen=-51.7, fillpen=-180.0, finish_word=fin)
    rj = jl.bestpath(lm=jx.lm, **kw)
    rp = pl.bestpath(lm=pt.lm, **kw)
    assert rp == rj
    assert rp[0]                                   # a real-word hypothesis
    assert pl._best_seg_scores == jl._best_seg_scores
    assert pl.posterior(lm=pt.lm) == jl.posterior(lm=jx.lm)
    assert pl.norm == jl.norm
    assert _links(pl, post=True) == _links(jl, post=True)
    for word, sf, ef in rp[1]:
        assert pl.node_posterior(word, sf) == jl.node_posterior(word, sf)
        assert pl.link_posterior(word, sf, ef) == \
            jl.link_posterior(word, sf, ef)


def test_nbest_and_prune_equal(lattices):
    jl, pl, jx, pt = lattices
    assert pl.nbest(5, lm=pt.lm, lwf=LWF) == jl.nbest(5, lm=jx.lm, lwf=LWF)
    assert pl.posterior_prune(-3.0, lm=pt.lm) == \
        jl.posterior_prune(-3.0, lm=jx.lm)
    assert _nodes(pl) == _nodes(jl)
    assert _links(pl) == _links(jl)


def test_write_read_round_trip(lattices, tmp_path):
    jl, pl, jx, pt = lattices
    pl.posterior(lm=pt.lm)
    jl.posterior(lm=jx.lm)
    for ext, write, read in (("lat", "write", "read"),
                             ("slf", "write_htk", "read_htk")):
        a, b = tmp_path / f"p.{ext}", tmp_path / f"j.{ext}"
        getattr(pl, write)(str(a))
        getattr(jl, write)(str(b))
        assert a.read_bytes() == b.read_bytes()
        kw = dict(dictionary=pt.dict) if read == "read" else {}
        back = getattr(Lattice, read)(str(a), **kw)
        jkw = dict(dictionary=jx.dict) if read == "read" else {}
        jback = getattr(JaxLattice, read)(str(a), **jkw)
        assert _nodes(back) == _nodes(jback)
        assert _links(back) == _links(jback)
        assert back.n_links > 0
        # the DAG round trip keeps every link with a finite score
        if read == "read":
            assert back.n_nodes <= pl.n_nodes
            assert back.bestpath(lm=pt.lm)[0] == jback.bestpath(lm=jx.lm)[0]
