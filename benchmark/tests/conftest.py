"""Fixtures of the benchmark's tests: a copy of `BENCHMARK.json` with the
tiny test configuration's cells added, and the card check (decided in a
fixture, never while a module is imported)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the test cells: the tiny configuration under each mix
TINY_CELLS = {"tiny.batch": "batch", "tiny.stream": "stream",
              "tiny.quick": "quick"}
#: a semi-continuous model with 5-state HMMs over the tiny task, under
#: the quick mix: another model type and topology by files and entries
SEMI5_CELL = "tiny-semi5.quick"


#: the stream entry point's metrics, which no cell of BENCHMARK.json
#: reports yet: the test cell "tiny.stream" brings them as entries
STREAM_METRICS = {
    "end_to_end": [{"name": "audio_s_per_s.stream", "unit": "audio-s/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock"}],
    "per_layer": [{"name": name, "unit": "ms", "better": "lower",
                   "source": source, "layer": "facade",
                   "moves": "audio_s_per_s.stream"}
                  for name, source in (("chunk_ms_p95", "host_clock"),
                                       ("final_ms_p50", "host_clock"),
                                       ("block_ms_p50", "program_span"),
                                       ("partial_ms_p50", "host_clock"))]}


@pytest.fixture
def spec_path(tmp_path):
    """A temporary copy of BENCHMARK.json with two configurations, four
    cells and the stream's metrics added, and each batch metric's cell
    list extended to the tiny batch cells: nothing else is edited."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "tiny", "source": "test only",
        "file": "benchmark/tests/data/tiny.json", "reduced": [],
        "why": "a 43-word task over a small synthetic model"})
    spec["configs"].append({
        "name": "tiny-semi5", "source": "test only",
        "file": "benchmark/tests/data/tiny-semi5.json", "reduced": [],
        "why": "the tiny task over one codebook and 5-state HMMs"})
    for name, mix in TINY_CELLS.items():
        spec["workloads"].append({"name": name, "config": "tiny",
                                  "traffic": mix, "chips": 1,
                                  "why": "test only"})
    spec["workloads"].append({"name": SEMI5_CELL, "config": "tiny-semi5",
                              "traffic": "quick", "chips": 1,
                              "why": "test only"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny.batch", "tiny.quick", SEMI5_CELL]
    for key, metrics in STREAM_METRICS.items():
        spec[key] += [dict(m, workloads=["tiny.stream"]) for m in metrics]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the chip)")
    return torch.device("cuda", 0)


def run_cell(spec_path, cell, seed=4000000123, seconds=0.0, trace=0,
             capsys=None):
    """Run `cell` on the CPU (or the card where there is one); returns
    (exit code, the result line or None, standard error)."""
    from benchmark.harness.main import main
    import io
    out, err = io.StringIO(), io.StringIO()
    rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)], allow_cpu=True,
              spec_path=spec_path, traffic_dir=DATA / "traffic",
              out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    line = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, line, err.getvalue()
