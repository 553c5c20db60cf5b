"""The port's grammar layer and FSG search against the JAX package's:

  * `FsgModel` text round trips (read and write, epsilon and zero-prob
    transitions) and the `null_closure` matrix, equal;
  * JSGF grammars compiled to equal FSGs (weights, groups, optionals,
    Kleene closures, rule references, tags, comments, imports), and the
    same `JsgfError` for each malformed grammar;
  * `FsgDecoder` over a seeded command grammar, fillers and alternate
    pronunciations on and off: the edited grammar and every host table
    equal, then the per-frame records (escore, estf, epra, eascr,
    final_score), hypothesis and segments bit-equal on one seeded cost
    matrix with a frame of forced ties."""

import numpy as np
import pytest

from pocketsphinx_tpu.lm.fsg import FsgModel as JFsgModel
from pocketsphinx_tpu.lm.jsgf import Jsgf as JJsgf, JsgfError as JJsgfError
from pocketsphinx_tpu.search.fsg import FsgDecoder as JFsgDecoder
from pocketsphinx_tpu_torch.lm.fsg import FsgModel
from pocketsphinx_tpu_torch.lm.jsgf import Jsgf, JsgfError
from pocketsphinx_tpu_torch.search.fsg import FsgDecoder
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import (  # noqa: F401
    assert_records_equal, dictionary_with_alternates, model_pair, tie_costs,
    torch_one_thread)

FSG_TEXT = """# a grammar file
FSG_BEGIN turtle
NUM_STATES 7
START_STATE 0
FINAL_STATE 6
TRANSITION 0 1 1.0 go
T 1 2 0.5 forward
T 1 2 0.5 backward
T 2 3 0.3
T 2 4 0.7 ten
T 3 4 1.0 meters
T 4 5 0.0 zero
TRANSITION 4 6 1.0
T 5 6 0.25
FSG_END
"""


def _links(fsg):
    return ([(l.src, l.dst, l.logprob, l.wid) for l in fsg.links],
            fsg.vocab, (fsg.name, fsg.n_state, fsg.start_state,
                        fsg.final_state, fsg.lw))


def test_fsg_file_roundtrip(tmp_path):
    path = tmp_path / "g.fsg"
    path.write_text(FSG_TEXT)
    p, j = FsgModel.readfile(str(path), lw=6.5), \
        JFsgModel.readfile(str(path), lw=6.5)
    assert _links(p) == _links(j)
    assert any(l.wid < 0 for l in p.links) and \
        any(not np.isfinite(l.logprob) for l in p.links)
    p.writefile(str(tmp_path / "p.fsg"))
    j.writefile(str(tmp_path / "j.fsg"))
    assert (tmp_path / "p.fsg").read_text() == \
        (tmp_path / "j.fsg").read_text()
    again = JFsgModel.readfile(str(tmp_path / "p.fsg"), lw=6.5)
    assert [(l.src, l.dst, l.wid) for l in again.links] == \
        [(l.src, l.dst, l.wid) for l in p.links]


def test_null_closure_equal(tmp_path):
    path = tmp_path / "g.fsg"
    path.write_text(FSG_TEXT)
    p, j = FsgModel.readfile(str(path)), JFsgModel.readfile(str(path))
    for m in (p, j):            # an epsilon chain and a cycle
        m.null_trans_add(3, 1, -20.0)
        m.null_trans_add(0, 3, -5.0)
    cp, cj = p.null_closure(), j.null_closure()
    np.testing.assert_array_equal(cp, cj)
    assert cp[0, 1] == -25.0 and cp[2, 1] == cp[2, 3] - 20.0 < 0
    assert cp[6, 0] == -np.inf
    assert (np.diag(cp) == 0).all()
    assert p.add_alt("go", "went") == j.add_alt("go", "went") == 1
    assert _links(p) == _links(j)


GRAMMARS = {
    "weights": """#JSGF V1.0; grammar a;
        public <cmd> = /0.7/ go <dir> | /0.3/ stop [now];
        <dir> = forward | backward | (turn (left | right));""",
    "closures": """#JSGF V1.0 UTF-8 en;
        grammar b; import <c.d>;
        // comment
        public <a> = <com.x.b>* then <b>+ {tag} [ <b> ];
        <b> = one | two /* block */ | three;""",
    "toprule": """#JSGF V1.0; grammar c;
        public <x> = a b; public <y> = c [d] e+;""",
    "empty": """#JSGF V1.0; grammar d;
        public <z> = ( ) | x;""",
}


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_jsgf_fsg_equal(name):
    text = GRAMMARS[name]
    p, j = Jsgf(text), JJsgf(text)
    assert (p.name, p.public, sorted(p.rules)) == \
        (j.name, j.public, sorted(j.rules))
    for rule in [None] + p.public:
        assert _links(p.build_fsg(rule, lw=6.5)) == \
            _links(j.build_fsg(rule, lw=6.5))


@pytest.mark.parametrize("text,rule", [
    ("public <a> = b;", None),                              # no header
    ("#JSGF V1.0; public <a> = <a> b;", None),              # recursive
    ("#JSGF V1.0; public <a> = <nope>;", None),             # undefined
    ("#JSGF V1.0; public <a> = ( b;", None),
    ("#JSGF V1.0; public <a> = [ b;", None),
    ("#JSGF V1.0; public <a> = b /2/ c;", None),
    ("#JSGF V1.0; public <a> = b", None),                   # no ';'
    ("#JSGF V1.0; <a> = b;", None),                         # no public
    ("#JSGF V1.0; public <a> = b;", "c"),                   # no such rule
])
def test_jsgf_errors_equal(text, rule):
    with pytest.raises(JJsgfError) as je:
        JJsgf(text).build_fsg(rule)
    with pytest.raises(JsgfError) as pe:
        Jsgf(text).build_fsg(rule)
    assert str(pe.value) == str(je.value)
    assert issubclass(JsgfError, ValueError)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsg")
    dic = str(d / "alt.dic")
    words = dictionary_with_alternates(dic, n_words=30, seed=3)
    spec = synth.make_model([dic], seed=4, n_sen=126 + 300, n_density=8)
    jax_side, port_side = model_pair(spec, str(d), dic)
    # the words with alternates (the first multi-phone ones) are verbs
    gram = ("#JSGF V1.0; grammar cmd;\n"
            "public <cmd> = <verb> <object> [<mod>];\n"
            f"<verb> = {' | '.join(words[:6])};\n"
            f"<object> = {' | '.join(words[6:16])};\n"
            f"<mod> = {' | '.join(words[16:20])};\n")
    return jax_side, port_side, gram


TABLES = ("senid", "tp", "chain_pred", "node_arc", "first_node",
          "exit_node", "exit_node_sil", "M", "start_entry", "final_reach")


@pytest.mark.parametrize("use_filler,use_altpron",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_fsg_decoder_equal(task, use_filler, use_altpron):
    (jam, jd2p), (pam, pd2p), gram = task
    kw = dict(use_filler=use_filler, use_altpron=use_altpron)
    jx = JFsgDecoder(jam, jd2p, JJsgf(gram).build_fsg(lw=6.5), **kw)
    pt = FsgDecoder(pam, pd2p, Jsgf(gram).build_fsg(lw=6.5), device="cpu",
                    **kw)
    assert _links(pt.fsg) == _links(jx.fsg)     # the edited grammar
    assert (pt.A, pt.P, pt.words) == (jx.A, jx.P, jx.words)
    plain = Jsgf(gram).build_fsg().links
    n_arcs = sum(l.wid >= 0 for l in plain)
    # the alternates' arcs join the grammar, but as in the JAX search their
    # "w(2)" labels are no dictionary key, so they drop out of the network
    assert (len(pt.fsg.links) > len(plain)) == (use_filler or use_altpron)
    assert (pt.A > n_arcs) == use_filler
    for k in TABLES:
        a, b = getattr(jx, k), getattr(pt, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    costs = tie_costs(pam.n_sen, 40, seed=6)
    hj, sj = jx.decode(None, costs=costs)
    hp, sp = pt.decode(None, costs=costs)
    assert_records_equal(pt.records, jx.records,
                         "escore estf epra eascr final_score".split())
    assert (hp, [(s.word, s.start, s.end) for s in sp]) == \
        (hj, [(s.word, s.start, s.end) for s in sj])
    assert hp
