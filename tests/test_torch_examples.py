"""The port's examples (`examples/torch_*.py`) against the JAX package's
(`examples/*.py`) on a synthetic model, run on the CPU (`--device cpu`):

  * `torch_stream_server.py --stdio`, as a program reading seeded bursts
    of PCM (`synth.bursts_pcm`) on its standard input, writes the events
    that `examples/stream_server.py`'s `serve` gives on the same input, in
    n-gram mode and with `-kws`;
  * `torch_simple.py`, `torch_live.py`, `torch_segment.py` and
    `torch_batch.py` print what `simple.py`, `live.py`, `segment.py` and
    `batch_tpu.py` print under a PS_REFERENCE tree that the test writes
    from the synthetic model (`synth.small_task`: the model directory as
    model/en-us/en-us, its dictionary and ARPA LM as test/data/turtle.dic
    and turtle.lm.bin, seeded PCM as test/data/goforward.raw);
  * without a PS_REFERENCE or flags an example says what it lacks."""

import contextlib
import io
import json
import os
import pathlib
import runpy
import shutil
import subprocess
import sys
import wave

import numpy as np
import pytest

from pocketsphinx_tpu_torch.testing import synth
from _torch_jax_helpers import torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """A PS_REFERENCE tree over `synth.small_task`, and its files."""
    d = tmp_path_factory.mktemp("examples")
    hmm, dic, lmf = synth.small_task(str(d / "task"), seed=7)
    root = d / "ref"
    model = root / "model" / "en-us" / "en-us"
    data = root / "test" / "data"
    data.mkdir(parents=True)
    shutil.copytree(hmm, model)
    shutil.copy(dic, data / "turtle.dic")
    shutil.copy(lmf, data / "turtle.lm.bin")     # read by its content
    (data / "goforward.raw").write_bytes(
        synth.make_pcm(90, 1.5).astype("<i2").tobytes())
    bursts = synth.bursts_pcm(51, 4.0)
    wav = d / "bursts.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(bursts.astype("<i2").tobytes())
    kws = synth.write_keyphrases(dic, str(d / "k.txt"), seed=3, n=6)
    return dict(root=str(root), hmm=str(model), dic=str(data / "turtle.dic"),
                lm=str(data / "turtle.lm.bin"), wav=str(wav), kws=kws,
                bursts=bursts)


def run_example(name, argv, monkeypatch, env=None):
    """Run examples/`name` in this process as its own program with
    `argv`; returns what it printed.  Raises unless it exits 0."""
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(sys, "argv", [str(EXAMPLES / name)] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_path(str(EXAMPLES / name), run_name="__main__")
        except SystemExit as e:
            assert e.code in (0, None), (name, e.code)
    return out.getvalue()


@pytest.mark.parametrize("name,argv", [
    ("simple", []),
    ("live", ["wav"]),
    ("segment", ["wav"]),
    ("batch", []),
])
def test_example_prints_as_jax(ref, monkeypatch, name, argv):
    argv = [ref[a] for a in argv]
    env = {"PS_REFERENCE": ref["root"]}
    jax_name = "batch_tpu.py" if name == "batch" else f"{name}.py"
    want = run_example(jax_name, argv, monkeypatch, env)
    port_argv = argv if name == "segment" else ["--device", "cpu"] + argv
    got = run_example(f"torch_{name}.py", port_argv, monkeypatch, env)
    assert want.strip()
    assert got == want
    if name in ("live", "segment"):
        assert len(got.splitlines()) >= 2        # the VAD found speech


def test_example_flags_instead_of_reference(ref, monkeypatch):
    """The paths may come from flags; without them or PS_REFERENCE the
    example exits saying what it lacks."""
    monkeypatch.delenv("PS_REFERENCE", raising=False)
    raw = os.path.join(ref["root"], "test", "data", "goforward.raw")
    flags = ["--device", "cpu", "-hmm", ref["hmm"], "-lm", ref["lm"],
             "-dict", ref["dic"], raw]
    got = run_example("torch_simple.py", flags, monkeypatch)
    want = run_example("torch_simple.py", ["--device", "cpu"], monkeypatch,
                       {"PS_REFERENCE": ref["root"]})
    assert got == want
    monkeypatch.delenv("PS_REFERENCE")
    with pytest.raises(SystemExit, match="PS_REFERENCE"):
        runpy.run_path(str(EXAMPLES / "torch_simple.py"),
                       run_name="__main__")


def jax_events(ref, flags, pcm):
    """examples/stream_server.py's `serve` over `pcm`, in this process:
    its event lines."""
    from pocketsphinx_tpu.config import Config as JConfig
    mod = runpy.run_path(str(EXAMPLES / "stream_server.py"),
                         run_name="jax_stream_server")
    data, out = io.BytesIO(pcm.astype("<i2").tobytes()), io.BytesIO()
    kw = {flags[i].lstrip("-"): flags[i + 1] for i in range(0, len(flags), 2)}
    mod["serve"](data.read, out.write, JConfig(**kw))
    return out.getvalue().decode().splitlines()


@pytest.mark.parametrize("mode", ["ngram", "kws"])
def test_stream_server_stdio_events_equal_jax(ref, mode):
    flags = ["-hmm", ref["hmm"], "-dict", ref["dic"]]
    flags += ["-lm", ref["lm"]] if mode == "ngram" else ["-kws", ref["kws"]]
    pcm = ref["bursts"]
    want = jax_events(ref, flags, pcm)
    r = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_stream_server.py"),
         "--stdio", "--device", "cpu", *flags],
        input=pcm.astype("<i2").tobytes(), capture_output=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    got = r.stdout.decode().splitlines()
    assert got == want
    events = [json.loads(x)["event"] for x in got]
    assert events.count("start") >= 2 and "final" in events
    if mode == "ngram":
        assert "partial" in events
