"""A configuration's model type, feature type and HMM topology decide
what the harness builds, what the reference computes and what the counts
count, each by a file found by its name: the PTM model's files and the
en-us-126k counts are what they were before, the reference's features
of each type agree with the frozen copy and with the port, and a name
with no file fails by its key."""

import ast
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark.counts.kernels import step_counts
from benchmark.harness.cells import BENCH, feat_type, model_type
from benchmark.harness.corpus import Corpus
from benchmark.harness.task import prepare
from conftest import DATA, SEMI5_CELL, run_cell


def _conf(name="tiny.json", model=(), **top):
    """A test configuration, with keys of its `model` and top-level keys
    changed."""
    conf = json.loads((DATA / name).read_text())
    conf["name"] = name.removesuffix(".json")
    conf["model"] = dict(conf["model"], **dict(model))
    return dict(conf, **top)


def _files(hmm):
    return {f: hashlib.sha256((hmm / f).read_bytes()).hexdigest()
            for f in sorted(os.listdir(hmm))}


#: the files of the tiny PTM configuration's model directory for seed
#: 4000000123, as the harness wrote them before model types were files
#: of their own (commit 10ae9a0)
TINY_PTM_FILES = {
    "feat.params": "f447b7f756d17f3181e77977a94022fc"
                   "75f7d3a4502bf14b897c881507b7cf13",
    "mdef": "06cf6cb7806d59b60cce7ffb483acda4"
            "43c77f9b0dc01087d359eeb045bd8f91",
    "means": "b1f3fc476630aabdb99b1fa29e7d1873"
             "789d31a73b44444af4fb6b3d0ba6ba1c",
    "mixture_weights": "fcfa02196d022a248d25f1544f943859"
                       "e70b9780a6d74bab8ed7c911a128bffd",
    "noisedict": "7295b07df2c204c4f87c6782b6be1a38"
                 "59d7006d4e3864181c955d6dab105a33",
    "transition_matrices": "86604435ec51ce2d40b2e5a744b1643a"
                           "b3077270d2287a34b27e2f7dcee451f1",
    "variances": "66dac1f37b0f05d3cbe313baa286944f"
                 "33741a3842af80b5cb69d9aa99bd005b"}


def test_ptm_model_files_as_before(tmp_path):
    t = prepare(_conf(), 4000000123, str(tmp_path))
    assert _files(tmp_path / "hmm") == TINY_PTM_FILES
    assert t["hmm"] == str(tmp_path / "hmm")


#: the reference decoder's step shapes for en-us-126k (B=8 rows), and the
#: counts the harness made of them before the counts followed the model
#: (commit 10ae9a0; both read on an H100, seed 2318000001)
EN_US_126K_SHAPES = dict(
    NRC=41, W=125973, LP=601, NST=3, nE=128258, K=96,
    buckets=[[5, 75301, 39, 610], [7, 32819, 39, 436], [8, 8188, 39, 258],
             [16, 9665, 39, 239], [5, 5, 0, 0]],
    n_cb=42, featlen=[13, 13, 13], n_density=128, n_sen=5126)
EN_US_126K_COUNTS = {
    "fan_bytes": 3173357924, "fan_s": 0.0009472710220895523,
    "chain_bytes": 638905407, "chain_s": 0.0001907180319402985,
    "transitions_bytes": 44515508, "scoring_flops": 38203392,
    "step_s": 0.0011518474652537313}


def test_en_us_126k_counts_as_before():
    assert step_counts(EN_US_126K_SHAPES, 8) == EN_US_126K_COUNTS


def _cep(B=4, T=57, lengths=(57, 40, 23, 9), seed=5):
    """Seeded cepstra [B, T, 13] with unequal lengths (the padding is
    noise, which no valid feature may read), c0 about half >= 0."""
    g = torch.Generator().manual_seed(seed)
    cep = torch.randn(B, T, 13, generator=g) * 3.0
    return cep, torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize("cmn", ["batch", "none"])
def test_1s_c_d_dd_reference_is_the_frozen_copy(cmn):
    from benchmark.reference.psref.frontend.feat import compute_feats
    cep, n = _cep()
    got = feat_type({"feat": "1s_c_d_dd"}).features(cep, n, cmn)
    assert torch.equal(got, compute_feats(cep, n, cmn=cmn))
    assert feat_type({"feat": "1s_c_d_dd"}).FEATLEN == [13, 13, 13]


@pytest.mark.parametrize("cmn", ["batch", "none"])
def test_s2_4x_reference_is_the_ports_per_utterance(cmn):
    """Each row of a B=4 batch of unequal lengths against the port's
    host features of that utterance alone.  Without CMN the two are the
    same float32 differences and equal bit for bit.  With batch CMN each
    takes the mean of the kept frames in its own order (NumPy's pairwise
    sum over one utterance, torch's over the padded row), so a mean, and
    every feature that reads c(t) without a difference, can differ by
    float32 rounding of a sum of some 50 terms of size 10 (read: at most
    1.9e-6 on five seeds): 1e-5 bounds that, and a feature off by one
    frame or lane reads off by about 1."""
    from pocketsphinx_tpu_torch.frontend.feat import compute_feats_typed
    cep, n = _cep()
    ref = feat_type({"feat": "s2_4x"})
    got = ref.features(cep, n, cmn)
    assert got.shape == (4, 57, 4, 24) and ref.FEATLEN == [12, 24, 3, 12]
    for b, nb in enumerate(n.tolist()):
        want, featlen = compute_feats_typed(cep[b, :nb].numpy(), "s2_4x",
                                            cmn=cmn)
        assert featlen == ref.FEATLEN
        row = got[b, :nb].numpy()
        if cmn == "none":
            np.testing.assert_array_equal(row, want)
        else:
            np.testing.assert_allclose(row, want, rtol=0, atol=1e-5)
    # the padded frames' cepstra are read by no feature; past a stream's
    # width every lane is zero
    other = cep.clone()
    for b, nb in enumerate(n.tolist()):
        other[b, nb:] = -cep[b, nb:] + 7.0
    assert torch.equal(ref.features(other, n, cmn), got)
    for f, width in enumerate(ref.FEATLEN):
        assert not got[:, :, f, width:].any()


def test_s2_4x_reference_imports_nothing_of_the_program():
    tree = ast.parse((BENCH / "reference" / "feat" / "s2_4x.py").read_text())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)]
    assert names == ["torch"]


def test_semi_writes_one_codebook_of_unequal_streams(tmp_path):
    """An s2_4x semi-continuous model: one codebook over streams of 12,
    24, 3 and 12 lanes, read back by the port's loader as such, with the
    feature type in its feat.params."""
    from pocketsphinx_tpu_torch.models.acoustic import AcousticModel
    conf = _conf("tiny-semi5.json", feat="s2_4x",
                 model=dict(n_feat=4, featlen=[12, 24, 3, 12]))
    t = prepare(conf, 77, str(tmp_path))
    am = AcousticModel.load(t["hmm"])
    assert am.model_type == "semi"
    g = am.gauden
    assert (g.n_mgau, g.n_density) == (1, 16)
    assert list(g.featlen) == [12, 24, 3, 12]
    assert am.mixw.mixw.shape == (4, 16, 710)
    assert am.tmat.tp.shape[1:] == (5, 6)
    spec = model_type(conf).make_weights(
        (tmp_path / "hmm" / "mdef").read_text(), 77, conf["model"], "s2_4x")
    for f, width in enumerate(g.featlen):
        np.testing.assert_array_equal(g.means[0, f, :, :width],
                                      spec.means[0, f, :, :width])
    params = (tmp_path / "hmm" / "feat.params").read_text()
    assert "-feat s2_4x\n" in params and "-model semi\n" in params
    assert "-svspec" not in params


@pytest.mark.parametrize("key,value,folder", [
    ("model_type", "s3cont", "inputs/models/s3cont.py"),
    ("feat", "1s_c_d_ld_dd", "reference/feat/1s_c_d_ld_dd.py"),
    ("feat", "../metrics/step_mfu", "reference/feat/../metrics")])
def test_a_name_with_no_file_fails_by_its_key(tmp_path, key, value, folder):
    conf = (_conf(model={key: value}) if key == "model_type"
            else _conf(**{key: value}))
    drv = Corpus(type("Cell", (), dict(config=conf, mix={"batch_size": 2},
                                        chips=1)), 5, None, str(tmp_path))
    with pytest.raises(ValueError) as e:
        drv.inputs()
    what = "model.model_type" if key == "model_type" else "feat"
    assert f"{what} = {value!r}: no file benchmark/{folder}" in str(e.value)
    assert not (tmp_path / "hmm").exists()


@pytest.mark.parametrize("name,model,changes,message", [
    ("tiny-semi5.json", {}, dict(feat="s2_4x"), "model streams"),
    # PTM weights are of one width: a PTM model that declares ragged
    # streams is refused, not written uniform
    ("tiny.json", dict(n_feat=4, featlen=[12, 24, 3, 12]),
     dict(feat="s2_4x"), r"model streams \[13, 13, 13, 13\]"),
    ("tiny-semi5.json", {}, dict(cmn_batch="live"), "cmn_batch = 'live'"),
    ("tiny-semi5.json", {}, dict(cmn_batch="none"), "cmn_batch = 'none'")])
def test_model_streams_and_cmn_are_checked(tmp_path, name, model, changes,
                                           message):
    conf = _conf(name, model=model, **changes)
    drv = Corpus(type("Cell", (), dict(config=conf, mix={"batch_size": 2},
                                        chips=1)), 5, None, str(tmp_path))
    with pytest.raises(ValueError, match=message):
        drv.inputs()
    assert not (tmp_path / "hmm").exists()


def test_stream_entry_point_refuses_other_types():
    from benchmark.harness.stream import Stream
    cell = type("Cell", (), dict(config=_conf("tiny-semi5.json"),
                                 mix={"chunk_s": 0.1, "partial_every": 3}))
    with pytest.raises(ValueError, match="model.model_type 'ptm'"):
        Stream(cell, 5, None, "")


def test_semi5_cell_by_files_and_entries(spec_path, capsys):
    """The tiny task over one codebook of 16 codewords and 5-state HMMs
    runs as a cell: correct, counted with one codebook and 5 states."""
    rc, line, err = run_cell(spec_path, SEMI5_CELL)
    assert rc == 0, err
    assert line["correct"] is True
    counts = json.loads(next(x for x in err.splitlines()
                             if x.startswith("counts "))[7:])
    s = counts["shapes"]
    assert (s["n_cb"], s["NST"], s["featlen"]) == (1, 5, [13, 13, 13])
    # B=2 rows (the quick mix): 4 * 39 lanes * 16 codewords, and each
    # senone's mixture over them, 2 * 3 streams * 16 * 710
    assert counts["counts"]["scoring_flops"] == 2 * (
        4 * 39 * 16 + 2 * 3 * 16 * 710)


def _alter_mixw(monkeypatch):
    """The port's copy of the mixture weights off by one unit of cost in
    one codeword of every senone of the first stream."""
    from pocketsphinx_tpu_torch.models import acoustic
    load = acoustic.AcousticModel.load.__func__

    def bad(cls, *a, **kw):
        am = load(cls, *a, **kw)
        w = am.mixw.mixw
        w[0, 0] = np.where(w[0, 0] < 255, w[0, 0] + 1, w[0, 0] - 1)
        return am
    monkeypatch.setattr(acoustic.AcousticModel, "load", classmethod(bad))


def test_semi5_mixture_weights_fault_is_not_correct(spec_path,
                                                    monkeypatch):
    _alter_mixw(monkeypatch)
    rc, line, err = run_cell(spec_path, SEMI5_CELL)
    assert rc == 0, err
    assert line["correct"] is False
    assert line["checks"]["senone_gap"]["value"] > 0
