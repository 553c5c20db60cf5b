"""The port's batch CLI (`cli_batch.main(..., device="cpu")`) against the
JAX package's `cli_batch.main`: over one synthetic model directory,
dictionary and LM and six seeded 16-bit WAV files (`-adcin yes`), both
write identical `-hyp` and `-hypseg` files, for the whole control file at
`-batchsize 4`, for `-ctloffset 1 -ctlcount 3`, and with `-mllrctl`
speaker groups (consecutive equal transform names, two transforms).
The two packages' costs differ within the scoring tolerance (2e-2
units); the outputs are equal at these seeds."""

import wave

import numpy as np
import pytest

from pocketsphinx_tpu import cli_batch as jax_cli_batch
from pocketsphinx_tpu_torch import cli_batch
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import torch_one_thread  # noqa: F401

SECONDS = (1.5, 1.0, 1.5, 1.2, 1.0, 1.2)


def write_wav(path, pcm, rate=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(pcm, "<i2").tobytes())


def _mllr_file(path, seed):
    rng = np.random.default_rng(seed)
    lines = ["1", "3"]
    for _ in range(3):
        A = np.eye(13) + 0.03 * rng.standard_normal((13, 13))
        lines += ["13"] + [" ".join(f"{x:.6f}" for x in row) for row in A]
        lines.append(" ".join(f"{x:.6f}" for x in 0.2 * rng.standard_normal(13)))
        lines.append(" ".join(f"{x:.6f}" for x in rng.uniform(0.9, 1.2, 13)))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_batch")
    hmm, dic, lmf = synth.small_task(str(d / "task"), seed=7)
    wavs = d / "wav"
    wavs.mkdir()
    ids = [f"utt{i}" for i in range(len(SECONDS))]
    for i, (u, s) in enumerate(zip(ids, SECONDS)):
        write_wav(wavs / f"{u}.wav", synth.make_pcm(80 + i, s))
    (d / "ctl").write_text("\n".join(ids) + "\n")
    for name, seed in (("spk_a", 4), ("spk_b", 5)):
        _mllr_file(d / f"{name}.mllr", seed)
    (d / "mllrctl").write_text("spk_a\nspk_a\nspk_b\nspk_b\nspk_b\nspk_a\n")
    base = ["-hmm", hmm, "-dict", dic, "-lm", lmf, "-ctl", str(d / "ctl"),
            "-adcin", "yes", "-cepdir", str(wavs), "-cepext", ".wav"]
    return d, base


CASES = {
    "all": ["-batchsize", "4"],
    "offset": ["-ctloffset", "1", "-ctlcount", "3", "-batchsize", "2"],
    "mllr": ["-mllrctl", "{d}/mllrctl", "-mllrdir", "{d}", "-mllrext",
             ".mllr", "-batchsize", "4"],
}


@pytest.mark.parametrize("case", CASES)
def test_outputs_equal_jax(corpus, case):
    d, base = corpus
    extra = [a.format(d=d) for a in CASES[case]]
    out = {}
    for pkg, run in (("jax", jax_cli_batch.main),
                     ("port", lambda a: cli_batch.main(a, device="cpu"))):
        hyp, seg = d / f"{case}.{pkg}.hyp", d / f"{case}.{pkg}.hypseg"
        assert run(base + extra + ["-hyp", str(hyp), "-hypseg",
                                   str(seg)]) == 0
        out[pkg] = (hyp.read_text(), seg.read_text())
    assert out["port"] == out["jax"]
    lines = out["port"][0].splitlines()
    assert len(lines) == (3 if case == "offset" else len(SECONDS))
    assert sum(ln.split(" (")[0] != "" for ln in lines) >= 2


def test_errors(corpus, capsys):
    d, base = corpus
    assert cli_batch.main(base[:6], device="cpu") == 1       # no -ctl
    assert "-ctl is required" in capsys.readouterr().err
    (d / "short_mllrctl").write_text("spk_a\n")
    assert cli_batch.main(base + ["-mllrctl", str(d / "short_mllrctl")],
                          device="cpu") == 1
    assert "File size mismatch" in capsys.readouterr().err
