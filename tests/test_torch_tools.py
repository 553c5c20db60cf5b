"""The port's host tools against the JAX package's, byte for byte:

  * the LM writers `write_arpa`, `write_trie_bin` and `write_dmp` on
    bench_data/bench-1.7k.lm.bin (1,754 / 30,397 / 33,132 n-grams) and on
    a seeded ARPA trigram LM (`ArpaBoLM` of a seeded corpus);
  * the mdef writers `write_bin_mdef` and `write_text_mdef` on a synthetic
    model's mdef (`synth.make_model`);
  * every `cli_tools` main (`lm_convert_main` to each format,
    `lm_eval_main`, `jsgf2fsg_main` to a file and to stdout,
    `mdef_convert_main` both ways, `pitch_main` to a file and to stdout):
    the files written, standard output and exit codes;
  * `ArpaBoLM` on a seeded corpus, `to_textgrid` of alignment entries,
    and `yin_pitch` on seeded PCM."""

import wave
from dataclasses import dataclass

import numpy as np
import pytest

from pocketsphinx_tpu import cli_tools as jax_tools
from pocketsphinx_tpu.fileio import bin_mdef as jax_bin_mdef
from pocketsphinx_tpu.lm import arpabo as jax_arpabo
from pocketsphinx_tpu.lm import ngram as jax_ngram
from pocketsphinx_tpu_torch import cli_tools
from pocketsphinx_tpu_torch.fileio import bin_mdef
from pocketsphinx_tpu_torch.lm import arpabo, ngram
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import torch_one_thread  # noqa: F401

BENCH_LM = str(synth.BENCH_DATA / "bench-1.7k.lm.bin")
PKGS = ((jax_ngram, jax_bin_mdef, jax_tools, jax_arpabo, "jax"),
        (ngram, bin_mdef, cli_tools, arpabo, "port"))


def _corpus(words, seed, n=40):
    """Seeded sentences over `words`, some with an utterance id."""
    rng = np.random.default_rng(seed)
    return "\n".join(" ".join(rng.choice(words, rng.integers(3, 9)))
                     + (" (utt%d)" % i if i % 3 == 0 else "")
                     for i in range(n))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    dic = str(d / "small.dic")
    words = synth.small_dictionary(dic, n_words=40, seed=3)
    arpa = str(d / "small.arpa")
    arpabo.ArpaBoLM(text=_corpus(words, 4), add_start=True).write_file(arpa)
    spec = synth.make_model([dic], seed=5, n_sen=126 + 300, n_density=4)
    mdef, _ = spec.write(str(d / "model"))
    pcm = synth.make_pcm(9, 1.0)
    with wave.open(str(d / "pitch.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype("<i2").tobytes())
    with open(d / "g.jsgf", "w") as f:
        f.write("#JSGF V1.0;\ngrammar g;\npublic <cmd> = (%s) [%s] %s;\n"
                % (" | ".join(words[:4]), words[4], words[5]))
    with open(d / "sents.txt", "w") as f:
        for i in range(5):
            f.write(" ".join(words[i:i + 6]) + "\n")
    return dict(d=d, arpa=arpa, mdef=mdef, pcm=pcm, words=words)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("writer", ["write_arpa", "write_trie_bin",
                                    "write_dmp"])
@pytest.mark.parametrize("lm", ["bench-1.7k", "seeded"])
def test_lm_writers_equal_jax(files, writer, lm):
    src = BENCH_LM if lm == "bench-1.7k" else files["arpa"]
    out = []
    for mod, *_, name in PKGS:
        # the DMP header holds the file's name: one name, two directories
        (files["d"] / name).mkdir(exist_ok=True)
        path = str(files["d"] / name / f"{lm}.{writer}")
        getattr(mod, writer)(mod.read_lm(src), path)
        out.append(_bytes(path))
    assert out[1] == out[0] and len(out[1]) > 1000


def test_mdef_writers_equal_jax(files):
    for writer in ("write_bin_mdef", "write_text_mdef"):
        out = []
        for _, mod, *_, name in PKGS:
            path = str(files["d"] / f"mdef.{writer}.{name}")
            getattr(mod, writer)(mod.read_bin_mdef(files["mdef"]), path)
            out.append(_bytes(path))
        assert out[1] == out[0] and len(out[1]) > 1000


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


TOOL_CASES = {
    "lm_convert_arpa": ("lm_convert_main",
                        ["-i", "{arpa}", "-o", "{out}", "-ofmt", "arpa"]),
    "lm_convert_bin": ("lm_convert_main",
                       ["-i", "{arpa}", "-o", "{out}", "-ofmt", "bin"]),
    "lm_convert_dmp": ("lm_convert_main",
                       ["-i", "{arpa}", "-o", "{out}", "-ofmt", "dmp"]),
    "lm_convert_bad": ("lm_convert_main",
                       ["-i", "{arpa}", "-o", "{out}", "-ofmt", "xyz"]),
    "lm_convert_usage": ("lm_convert_main", []),
    "lm_eval": ("lm_eval_main", ["-lm", "{arpa}", "-text", "{sent}",
                                 "-ctl", "{d}/sents.txt"]),
    "lm_eval_usage": ("lm_eval_main", []),
    "jsgf2fsg_file": ("jsgf2fsg_main", ["-jsgf", "{d}/g.jsgf",
                                        "-fsg", "{out}"]),
    "jsgf2fsg_stdout": ("jsgf2fsg_main", ["-jsgf", "{d}/g.jsgf"]),
    "mdef_text": ("mdef_convert_main", ["-text", "{mdef}", "{out}"]),
    "mdef_bin": ("mdef_convert_main", ["{mdef}", "{out}"]),
    "mdef_usage": ("mdef_convert_main", ["{mdef}"]),
    "pitch_file": ("pitch_main", ["-i", "{d}/pitch.wav", "-o", "{out}"]),
    "pitch_stdout": ("pitch_main", ["-i", "{d}/pitch.wav"]),
}


@pytest.mark.parametrize("case", TOOL_CASES)
def test_cli_tools_equal_jax(files, capsys, case):
    fn, argv = TOOL_CASES[case]
    got = []
    for *_, tools, _, name in PKGS:
        (files["d"] / name).mkdir(exist_ok=True)
        out = files["d"] / name / f"{case}.out"
        a = [x.format(out=out, sent=" ".join(files["words"][:5]),
                      **{k: v for k, v in files.items()}) for x in argv]
        rc, text = _run(getattr(tools, fn), a, capsys)
        got.append((rc, text, _bytes(out) if out.exists() else None))
    assert got[1] == got[0]
    rc, text, data = got[1]
    assert (rc == 0) == (not case.endswith(("_usage", "_bad")))
    assert rc or text or data


def test_arpabo_equal_jax(files, tmp_path):
    text = _corpus(files["words"], 6)
    outs = []
    for *_, mod, name in PKGS:
        for kw in (dict(add_start=True), dict(discount_mass=0.3,
                                              case="upper")):
            lm = mod.ArpaBoLM(text=text, **kw)
            path = str(tmp_path / f"lm.{name}.{len(outs)}.arpa")
            lm.write_file(path)
            outs.append(_bytes(path))
    assert outs[2:] == outs[:2] and b"\\3-grams:" in outs[2]
    with pytest.raises(ValueError, match="discount_mass"):
        arpabo.ArpaBoLM(text=text, discount_mass=1.5)


@dataclass
class _Entry:
    start: int
    duration: int
    text: str


def test_to_textgrid_and_yin_equal_jax(files, tmp_path):
    words = [_Entry(0, 12, "<sil>"), _Entry(12, 40, "hello"),
             _Entry(52, 33, "world")]
    phones = [_Entry(12, 10, "HH"), _Entry(22, 30, "AH"),
              _Entry(52, 33, "W")]
    got = [mod.to_textgrid(words, phones, str(tmp_path / f"tg.{name}"))
           for *_, mod, name in PKGS]
    assert got[1] == got[0] and _bytes(tmp_path / "tg.port") == \
        _bytes(tmp_path / "tg.jax")
    assert jax_arpabo.to_textgrid([]) == arpabo.to_textgrid([])
    f0 = [tools.yin_pitch(files["pcm"], 16000, frame_shift=160,
                          frame_size=410) for *_, tools, _, _ in PKGS]
    assert f0[1].dtype == f0[0].dtype
    np.testing.assert_array_equal(f0[1], f0[0])
    assert (f0[1] > 0).any() and (f0[1] == 0).any()
