"""The readers of the program's counters (`padding_share`, `capture_s`,
`host_syncs_per_batch`), the trace reduction with the program's "ps."
spans in it, and a traced run that reports the three."""

import pytest
from pytest import approx

from benchmark.harness.cells import metric_reader
from benchmark.harness.trace import reduce_events
from conftest import run_cell

NEW = ("padding_share", "capture_s", "host_syncs_per_batch")


@pytest.fixture
def counters(monkeypatch):
    """Hand the readers the counters of a dict the test fills."""
    from pocketsphinx_tpu_torch import profile
    held = {}
    monkeypatch.setattr(profile, "counters", lambda: dict(held))
    return held


def test_padding_share(counters):
    read = metric_reader("padding_share")
    assert read({}) is None
    counters.update({"scan.lane_frames": 17024, "scan.real_frames": 10738})
    assert read({}) == approx(100 * (1 - 10738 / 17024))
    counters["scan.real_frames"] = 17024
    assert read({}) == 0.0


def test_capture_s(counters):
    read = metric_reader("capture_s")
    assert read({}) == 0.0            # nothing captured
    counters["capture_s"] = 0.25
    assert read({}) == 0.25


def test_host_syncs_per_batch(counters):
    read = metric_reader("host_syncs_per_batch")
    assert read({}) is None
    counters.update({"scan.batches": 4, "host_syncs": 90})
    assert read({}) == 22.5


def test_silent_without_the_program_counters(monkeypatch):
    """A program that keeps no counters (before the "ps." spans and
    counters existed) gives no reading, and no error."""
    from pocketsphinx_tpu_torch import profile
    monkeypatch.delattr(profile, "counters")
    for name in NEW:
        assert metric_reader(name)({}) is None


class Ev:
    def __init__(self, name, start, dur, dev):
        self._n, self._s, self._d, self.dev = name, start, dur, dev

    def device_index(self):
        return 0

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._n.startswith(("bench.", "ps."))


def test_program_spans_name_gaps_and_add_no_device_work():
    """A "ps." span's device-side annotation is no device work; an idle
    gap takes the name of the innermost "ps." span open over it."""
    evs = [Ev("k1", 100, 80, True), Ev("k1", 300, 100, True),
           Ev("bench.decode_corpus", 0, 1000, False),
           Ev("ps.corpus", 5, 990, False), Ev("ps.batch", 10, 980, False),
           Ev("ps.segments", 190, 100, False),
           Ev("aten::copy_", 150, 20, False)]
    plain = reduce_events(evs, 0, 1000, is_device=lambda e: e.dev)
    annotated = reduce_events(
        evs + [Ev("ps.scan", 90, 300, True), Ev("ps.batch", 10, 980, True)],
        0, 1000, is_device=lambda e: e.dev)
    for tr in (plain, annotated):
        assert tr.busy_s == approx(180e-9)
        assert tr.ops == {"k1": [approx(180e-9), 2]}
        # gaps: 400-1000 (600), 180-300 (120), 0-100 (100)
        assert [g[0] for g in tr.idle_gaps] == [
            "ps.batch", "ps.segments", "ps.batch"]
        assert not any(name.startswith("ps.") for name, _ in tr.top_ops())


def test_traced_run_reports_the_counters(spec_path):
    rc, line, err = run_cell(spec_path, "tiny.quick", trace=1)
    assert rc == 0, err
    m = line["metrics"]
    assert set(NEW) <= set(m)
    assert m["capture_s"]["value"] == 0.0          # the CPU captures none
    assert 0.0 < m["padding_share"]["value"] < 100.0
    assert m["host_syncs_per_batch"]["value"] >= 8
    assert m["host_syncs_per_batch"]["unit"] == "syncs/batch"
