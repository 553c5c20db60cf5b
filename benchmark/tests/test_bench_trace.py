"""The trace reduction: busy time as the union of device intervals, the
idle gaps named by the host's innermost operation, the host launches."""

from pytest import approx

from benchmark.harness.trace import reduce_events


class Ev:
    def __init__(self, name, start, dur, dev, card=0):
        self._n, self._s, self._d, self.dev = name, start, dur, dev
        self.card = card

    def device_index(self):
        return self.card

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._n.startswith("bench.")


def test_union_gaps_and_launches():
    evs = [Ev("k1", 100, 50, True), Ev("k2", 120, 60, True),   # 100-180
           Ev("k1", 300, 100, True),                           # 300-400
           Ev("cudaLaunchKernel", 90, 5, False),
           Ev("cudaGraphLaunch", 290, 5, False),
           Ev("outer", 0, 1000, False), Ev("inner", 200, 50, False),
           Ev("bench.window", 0, 1000, True),
           Ev("bench.window", 0, 1000, False)]
    tr = reduce_events(evs, 0, 1000, is_device=lambda e: e.dev)
    assert tr.busy_s == approx(180e-9)
    assert tr.window_s == approx(1000e-9)
    assert tr.host_launches == 2
    assert tr.ops["k1"] == [approx(150e-9), 2]
    assert tr.op_time("k") == (approx(210e-9), 3)
    # gaps: 400-1000 (600), 0-100 (100), 180-300 (120; "inner" at 240)
    assert [g[0] for g in tr.idle_gaps] == ["outer", "inner", "outer"]
    assert [round(g[1] * 1e9) for g in tr.idle_gaps] == [600, 120, 100]
    assert tr.top_ops(1) == [["k1", approx(150e-9)]]


def test_busy_is_averaged_over_cards():
    """Two cards, busy 100 and 300 ns of a 1000 ns window: 200 ns busy
    on average; the idle gaps are where neither card was busy."""
    evs = [Ev("k", 0, 100, True, 0), Ev("k", 50, 300, True, 1),
           Ev("outer", 0, 1000, False)]
    tr = reduce_events(evs, 0, 1000, is_device=lambda e: e.dev, chips=2)
    assert tr.busy_s == approx(200e-9)
    assert [round(g[1] * 1e9) for g in tr.idle_gaps] == [650]
