"""The port's `pocketsphinx-tpu-torch` program (`cli.main(argv,
device="cpu")`) against the JAX package's `cli.main`, over one synthetic
model directory, dictionary and LM (`synth.small_task`) and seeded 16-bit
WAV files: `single` (with and without `-backtrace yes`, whose table goes
to stderr), `align` with `-phone_align yes` and with `-state_align yes`,
`live` from a file and from stdin (VAD-segmented bursts), `config`,
`soxflags`, `help`, an unknown command and missing arguments.  Standard
output and exit codes are equal.  Without CUDA the default device fails
with an error naming CUDA."""

import io
import sys
import wave

import numpy as np
import pytest
import torch

# both batch CLIs add their options to the shared parameter tables when
# imported: import both, so that `config` prints the same table
import pocketsphinx_tpu.cli_batch  # noqa: F401
import pocketsphinx_tpu_torch.cli_batch  # noqa: F401
from pocketsphinx_tpu import cli as jax_cli
from pocketsphinx_tpu_torch import cli
from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import torch_one_thread  # noqa: F401


def write_wav(path, pcm, rate=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(pcm, "<i2").tobytes())


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    hmm, dic, lmf = synth.small_task(str(d / "task"), seed=7)
    write_wav(d / "single.wav", synth.make_pcm(90, 1.5))
    live = synth.bursts_pcm(51, 3.0)
    write_wav(d / "live.wav", live)
    words = [ln.split()[0] for ln in open(dic)][:4]
    return dict(d=d, base=["-hmm", hmm, "-dict", dic], lm=["-lm", lmf],
                words=words, live=live)


def run_jax(argv, monkeypatch, capsys):
    """The JAX `cli.main` with its output functions writing to the
    captured streams (their default `stream` arguments hold the streams of
    import time)."""
    for f, stream in ((jax_cli.output_hyp, sys.stdout),
                      (jax_cli.output_align, sys.stdout),
                      (jax_cli.output_backtrace, sys.stderr),
                      (jax_cli.output_total_xrt, sys.stderr)):
        monkeypatch.setattr(f, "__defaults__", (stream,))
    rc = jax_cli.main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def run_port(argv, capsys):
    rc = cli.main(argv, device="cpu")
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_single_equal_jax(task, monkeypatch, capsys):
    argv = task["base"] + task["lm"] + ["single", str(task["d"] / "single.wav")]
    bt = argv[:-2] + ["-backtrace", "yes"] + argv[-2:]
    rc, out, _ = run_jax(bt, monkeypatch, capsys)
    assert rc == 0 and out.count("\n") == 1
    for a in (bt, argv):
        got = run_port(a, capsys)
        assert got[:2] == (rc, out)
    assert "INFO: word" in run_port(bt, capsys)[2]


@pytest.mark.parametrize("level", ["phone_align", "state_align"])
def test_align_equal_jax(task, monkeypatch, capsys, level):
    argv = task["base"] + [f"-{level}", "yes", "align",
                           str(task["d"] / "single.wav"), *task["words"]]
    want = run_jax(argv, monkeypatch, capsys)
    assert want[0] == 0 and '"w": [{' in want[1]
    assert run_port(argv, capsys)[:2] == want[:2]


def test_live_equal_jax(task, monkeypatch, capsys):
    argv = task["base"] + task["lm"] + ["live"]
    rc, out, _ = run_jax(argv + [str(task["d"] / "live.wav")], monkeypatch,
                         capsys)
    assert rc == 0 and out.count("\n") >= 2          # two VAD segments
    assert run_port(argv + [str(task["d"] / "live.wav")], capsys)[:2] == \
        (rc, out)
    stdin = io.TextIOWrapper(io.BytesIO(task["live"].astype("<i2").tobytes()))
    monkeypatch.setattr(sys, "stdin", stdin)
    assert run_port(argv + ["-"], capsys)[:2] == (rc, out)


@pytest.mark.parametrize("args", [
    ["config"], ["-samprate", "8000", "soxflags"], ["help"], ["nosuch"],
    [], ["single"], ["align", "x.wav"], ["-lm", "x.lm", "align", "x", "y"],
    ["-badopt", "1", "config"]])
def test_commands_equal_jax(task, monkeypatch, capsys, args):
    argv = task["base"] + args if args[:1] != ["-badopt"] else args
    want = run_jax(argv, monkeypatch, capsys)
    got = run_port(argv, capsys)
    assert got[:2] == want[:2]
    assert bool(got[2]) == bool(want[2])


def test_default_device_needs_cuda(task, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = task["base"] + task["lm"] + ["single", str(task["d"] / "single.wav")]
    assert cli.main(argv) == 1
    assert "CUDA" in capsys.readouterr().err
    assert cli.main(["soxflags"]) == 0                # needs no decoder
