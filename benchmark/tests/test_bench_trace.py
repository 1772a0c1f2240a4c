"""The reduction of a Chrome trace: the window, the union of device
operations, and the idle gaps under the host operation of their time."""

import pytest

from benchmark import harness


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_union_gaps_and_labels():
    events = [
        ev(harness.MARKER, "user_annotation", 100, 100),
        ev("aten::mm", "cpu_op", 100, 30),
        ev("aten::copy_", "cpu_op", 150, 40),
        ev("aten::copy_.inner", "cpu_op", 160, 10),
        ev("gemm", "kernel", 90, 30),          # clipped to [100, 120]
        ev("gemm", "kernel", 110, 20),         # overlaps: union [100, 130]
        ev("copy", "gpu_memcpy", 170, 10),
        ev("late", "kernel", 195, 20),         # clipped to [195, 200]
    ]
    t = harness.reduce_events(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((30 + 10 + 5) * 1e-6)
    assert t.device_ops["gemm"] == pytest.approx(40e-6)
    assert t.device_ops["late"] == pytest.approx(5e-6)
    # gaps: [130, 170] (mid 150: aten::copy_ opens there), [180, 195]
    # (mid 187.5: aten::copy_)
    assert t.idle_gaps == {"aten::copy_": pytest.approx(55e-6)}
    b = t.breakdown()
    assert b["device_ops"][0][0] == "gemm" and len(b["idle_gaps"]) == 1


def test_no_window_no_trace():
    with pytest.raises(harness.BenchError):
        harness.reduce_events([ev("gemm", "kernel", 0, 1)])


def test_percentile_and_merge():
    assert harness.percentile([], 95) is None
    assert harness.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert harness.percentile(list(range(21)), 95) == pytest.approx(19.0)
    assert harness.merge([(3, 4), (0, 1), (0.5, 2)]) == [[0, 2], [3, 4]]
