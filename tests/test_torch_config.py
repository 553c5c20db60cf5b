"""The port's `Config` equals the JAX package's: defaults, coercion,
`expand_model_config` on a synthetic model directory (its feat.params
merged under user settings), `validate_search_mode`, argument files and
the lenient JSON parser."""

import pytest

from pocketsphinx_tpu import config as jcfg
from pocketsphinx_tpu_torch import config as pcfg
from pocketsphinx_tpu_torch.testing import synth


def _values(c):
    return dict(c.items())


def test_params_and_defaults_equal():
    assert pcfg.PARAMS == jcfg.PARAMS
    assert _values(pcfg.Config()) == _values(jcfg.Config())


@pytest.mark.parametrize("args", [
    dict(beam="1e-60", lw=7, bestpath="no", samprate="8000", cmn="batch"),
    dict(fwdflat="TRUE", topn=2.0, hmm=None, ds="3"),
])
def test_coercion_equal(args):
    p, j = pcfg.Config(**args), jcfg.Config(**args)
    assert _values(p) == _values(j)
    assert {k: type(v) for k, v in p.items()} == \
        {k: type(v) for k, v in j.items()}
    assert all(p.is_user_set(k) == j.is_user_set(k) for k in args)


def test_bad_values_raise_alike():
    for cls in (pcfg.Config, jcfg.Config):
        with pytest.raises(ValueError, match="boolean"):
            cls(bestpath="maybe")
        with pytest.raises(KeyError):
            cls(no_such_option=1)


def test_argv_and_json_equal():
    argv = ["-lw", "8.5", "-dict", "x.dic", "-bestpath", "no"]
    assert _values(pcfg.Config(*argv)) == _values(jcfg.Config(*argv))
    text = "lw: 9\nfwdflat: no\ndict: a.dic"
    assert pcfg.parse_json(text) == jcfg.parse_json(text)
    assert _values(pcfg.Config(text)) == _values(jcfg.Config(text))
    assert pcfg.Config(lw=3).serialize_json() == \
        jcfg.Config(lw=3).serialize_json()


def test_expand_model_config_equal(tmp_path):
    hmm, dic, lmf = synth.small_task(str(tmp_path), n_words=8)
    assert pcfg.parse_args_file(hmm + "/feat.params") == \
        jcfg.parse_args_file(hmm + "/feat.params")
    p = pcfg.Config(hmm=hmm, dict=dic, lm=lmf, nfilt=30)
    j = jcfg.Config(hmm=hmm, dict=dic, lm=lmf, nfilt=30)
    p.default_search_args().expand_model_config()
    j.default_search_args().expand_model_config()
    assert _values(p) == _values(j)
    # the model's en-us front end, under the user's -nfilt
    assert (p["lowerf"], p["upperf"], p["transform"], p["lifter"],
            p["feat"], p["svspec"], p["cmn"], p["nfilt"]) == \
        (130.0, 6800.0, "dct", 22, "1s_c_d_dd", "0-12/13-25/26-38",
         "live", 30)
    assert p["mdef"] == hmm + "/mdef" and p["fdict"] == hmm + "/noisedict"
    assert p["mixw"] == hmm + "/mixture_weights"


@pytest.mark.parametrize("modes", [{}, {"lm": "a.lm"}, {"kws": "k.txt"},
                                   {"lm": "a.lm", "fsg": "g.fsg"}])
def test_validate_search_mode_equal(modes):
    p, j = pcfg.Config(**modes), jcfg.Config(**modes)
    if len(modes) > 1:
        for c in (p, j):
            with pytest.raises(ValueError, match="Only one"):
                c.validate_search_mode()
    else:
        assert p.validate_search_mode() == j.validate_search_mode()
