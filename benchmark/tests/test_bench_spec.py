"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every cell's configuration, mix, limits and metric readers by name."""

import json
import re

from benchmark.harness.cells import BENCH, ROOT, load_cell, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_every_cell_resolves_by_name():
    for w in SPEC["workloads"]:
        cell = load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["kind"] in ("corpus", "stream")
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        # each per-layer metric moves an end-to-end metric of its cell
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(metric_reader(m["name"]))


def test_config_files_state_their_cut():
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
        assert {"model", "frontend", "lm", "lm_mode", "precision",
                "assumed"} <= set(conf)


def test_tiny_cell_added_by_entries_alone(spec_path):
    """A new configuration and cells come in as files and entries: the
    harness resolves them from a copy of BENCHMARK.json, nothing else
    edited."""
    cell = load_cell("tiny.batch", spec_path)
    assert cell.config["name"] == "tiny"
    assert cell.mix == {**json.loads((BENCH / "traffic" / "batch.json")
                                     .read_text()), "name": "batch"}
    assert {m["name"] for m in cell.end_to_end} == {
        "audio_s_per_s", "peak_mem_gib", "setup_s"}
    assert "fan_roofline" in {m["name"] for m in cell.per_layer}
    assert "block_ms_p50" not in {m["name"] for m in cell.per_layer}


def test_data_files_are_pinned(tmp_path):
    conf = {"name": "x", "data_sha256": {"BENCHMARK.json": "0" * 64}}
    from benchmark.harness.cells import check_data
    import pytest
    with pytest.raises(ValueError):
        check_data(conf, ROOT)
