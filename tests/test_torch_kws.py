"""The port's keyword spotting against the JAX package's: `-kws` file
parsing (thresholds, malformed lines), the network tables, the
per-frame records (ratio and start frame of every keyphrase, bit-equal,
through a frame of forced ties) and the detections after the merge and
the `delay` filter, on one seeded cost matrix, including a keyphrase
with an unknown word (skipped by both)."""

from dataclasses import astuple

import numpy as np
import pytest

from pocketsphinx_tpu.search.kws import (KwsDecoder as JKwsDecoder,
                                         parse_kws_file as j_parse)
from pocketsphinx_tpu_torch.search.kws import KwsDecoder, parse_kws_file
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import (  # noqa: F401
    assert_records_equal, model_pair, scan_outputs, tie_costs,
    torch_one_thread)


def test_parse_kws_file(tmp_path, capsys):
    path = tmp_path / "k.txt"
    path.write_text("hello world /1e-20/\n\nbad /x/\n  plain phrase  \n"
                    "one/1e-5/\n")
    assert parse_kws_file(str(path), 1e-30) == j_parse(str(path), 1e-30) \
        == [("hello world", 1e-20), ("plain phrase", 1e-30), ("one", 1e-5)]
    assert "bad kws line" in capsys.readouterr().err


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("kws")
    dic = str(d / "small.dic")
    words = synth.small_dictionary(dic, n_words=30, seed=5)
    spec = synth.make_model([dic], seed=6, n_sen=126 + 300, n_density=8)
    kws = str(d / "k.txt")
    synth.write_keyphrases(dic, kws, seed=7, n=6)
    with open(kws, "a") as f:                 # single-phone, unknown word
        f.write(f"{words[-1]} /1e-90/\n{words[0]} nosuchword /1e-9/\n")
    return model_pair(spec, str(d), dic), kws


@pytest.mark.parametrize("delay", [0, 10, 200])
def test_kws_decoder_equal(task, delay, monkeypatch, capsys):
    ((jam, jd2p), (pam, pd2p)), kws = task
    jx = JKwsDecoder(jam, jd2p, j_parse(kws, 1e-30), plp=0.1, delay=delay)
    pt = KwsDecoder(pam, pd2p, parse_kws_file(kws, 1e-30), plp=0.1,
                    delay=delay, device="cpu")
    assert "nosuchword" in capsys.readouterr().err
    assert pt.keyphrases == jx.keyphrases and len(pt.keyphrases) == 7
    assert pt.thresholds == jx.thresholds
    for k in ("bg_senid", "bg_tp", "kw_senid", "kw_tp", "kw_len"):
        a, b = getattr(jx, k), getattr(pt, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    costs = tie_costs(pam.n_sen, 120, seed=8)
    seen = scan_outputs(monkeypatch)
    hj, sj = jx.decode(None, costs=costs)
    hp, sp = pt.decode(None, costs=costs)
    assert_records_equal(pt.records, seen[-1][1], ["ratio", "stf"])
    assert (hp, [(s.word, s.start, s.end) for s in sp]) == \
        (hj, [(s.word, s.start, s.end) for s in sj])
    dets = [astuple(x) for x in pt.detect(None, costs=costs)]
    assert dets == [astuple(x) for x in jx.detect(None, costs=costs)]
    if delay == 0:
        assert len(dets) >= 2
    if delay == 200:
        assert dets == []
