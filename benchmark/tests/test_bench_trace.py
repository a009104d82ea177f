"""The trace readers on a canned event list."""
import pytest

from benchmark.core import trace

BASE = 1_000_000_000_000


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def canned():
    # window 0..100 us; two streams overlap at 20..30
    events = [
        ev("void gator::trunk::gat_trunk_kernel<bf16, 128>(x)", 10, 20),
        ev("at::native::elementwise_kernel<add>", 20, 15),
        ev("gator::lbf_layer::rows_kernel<bf16>(a)", 40, 20),
        ev("Memcpy HtoD", 70, 5, "gpu_memcpy"),
        ev("cpu_op", 0, 100, "cpu_op"),
        ev("outside", 150, 10),
    ]
    us = 1000   # ns
    marks = [("window", BASE, BASE + 100 * us),
             ("serve_call", BASE, BASE + 60 * us),
             ("sync", BASE + 60 * us, BASE + 100 * us)]
    return trace.parse_events(events, marks, BASE)


def test_union_counts_overlap_once():
    tr = canned()
    assert tr.window_s == pytest.approx(100e-6)
    assert len(tr.device) == 4                     # cpu_op and outside out
    assert trace.busy_s(tr) == pytest.approx(50e-6)   # 10..35, 40..60, 70..75


def test_per_kernel_and_rest():
    tr = canned()
    assert trace.seconds(tr, r"\bgat_trunk_kernel\b") == pytest.approx(20e-6)
    assert trace.seconds(tr, r"\brows_kernel\b") == pytest.approx(20e-6)
    rest = trace.seconds_outside(
        tr, r"\b(gat_trunk_kernel|rows_kernel)\b")
    assert rest == pytest.approx(20e-6)           # 20..35 and 70..75


def test_idle_gaps_labelled_by_span():
    tr = canned()
    gaps = trace.idle_gaps(tr)
    assert gaps == [(0.0 + 0, 10.0), (35.0, 40.0), (60.0, 70.0),
                    (75.0, 100.0)]
    by = dict(trace.idle_by_span(tr))
    assert by["serve_call"] == pytest.approx(15e-6)
    assert by["sync"] == pytest.approx(35e-6)
    b = trace.breakdown(tr)
    assert len(b["device_ops"]) <= 10
    assert b["device_ops"][0][1] == pytest.approx(20e-6)


def test_idle_metric_reader():
    from benchmark.core import spec
    tr = canned()
    got = spec.metric_reader("device_idle_pct.serve").read({"trace": tr})
    assert got == pytest.approx(50.0)
    assert spec.metric_reader("device_idle_pct.serve").read({}) is None


def test_roofline_reader_never_zero():
    """A reader that finds no kernel returns nothing, not 0."""
    from benchmark.core import spec
    tr = canned()
    layer = {"trace": tr, "traced_steps": 1, "batch": 4,
             "cfg": spec.config("gator-h36m17")}
    assert spec.metric_reader("k4_roofline.train").read(layer) is None
