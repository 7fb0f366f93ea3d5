"""Whole runs of each cell on the CPU at a small size: the result line's
keys and metrics, untraced and traced. The CPU build of torch has no
device trace, so the traced run's stretches are timed on the host
instead; what reads them is the benchmark's own."""

import time

import pytest

import smallcells
from harness import spec

B = spec.load_benchmark()
CELLS = [w["name"] for w in B["workloads"]]


def _host_stretch(body, units, counters=None):
    from harness.trace import Stretch

    if counters is not None:
        counters.take()
        counters.active = True
    t = time.perf_counter()
    body()
    w = time.perf_counter() - t
    calls = []
    if counters is not None:
        counters.active = False
        calls = counters.take()
    return Stretch(w, w / 2, 10, {"brick4_fwd_kernel": w / 10}, units,
                   [("before gemm", w / 2)], calls)


@pytest.mark.parametrize("name", CELLS)
def test_untraced_line(name):
    line = smallcells.run_small(name)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    cell = spec.find_cell(name, B)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.limits["numbers"])


@pytest.mark.parametrize("name", CELLS)
def test_traced_line(name, monkeypatch):
    import harness.driver

    monkeypatch.setattr(harness.driver, "run_stretch", _host_stretch)
    line = smallcells.run_small(name, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    cell = spec.find_cell(name, B)
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["correct"] is True
