"""The port's span recorder (`gator_tpu_torch.profiling`): when it
records, the spans `trace` writes on the chrome trace's own clock,
`attribute` on a synthetic trace, the benchmark readers' placement of the
program's spans on a traced run's timeline, and the spans of a CPU
serving call and of CPU train steps.

The suite runs under xdist with one worker per file, and the recorder is
one buffer a process: every test empties it first."""
import json
import os.path as osp
import sys
import time

import numpy as np
import pytest
import torch

from gator_tpu_torch import losses, profiling

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

STAGES = ["serve.gat_embed", "serve.k1", "serve.gat_head",
          "serve.mdr_tokens", "serve.k2", "serve.head", "serve.upsample"]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear_marks()
    yield
    profiling.clear_marks()


def cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def names():
    return [m[0] for m in profiling.marks()]


@pytest.fixture(scope="module")
def small_model():
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import GatorSpec, build_gator
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                          seed=0)
    spec = GatorSpec.from_assets(assets, depth=2)
    return assets, spec, build_gator(spec, seed=3, device="cpu")


# -- the recorder -------------------------------------------------------------

def test_records_only_inside_a_profiler_and_cold_spans_always():
    with profiling.span("hot"):
        pass
    with profiling.span("cold", always=True):
        pass
    assert names() == ["cold"]
    with cpu_profile():
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
    with profiling.span("hot"):
        pass
    assert names() == ["cold", "inner", "outer"]     # in the order they end
    (_, i0, i1), (_, o0, o1) = profiling.marks()[1:]
    assert o0 <= i0 <= i1 <= o1
    assert profiling.marks() == profiling.marks()   # reading keeps them
    profiling.clear_marks()
    assert profiling.marks() == []


def test_buffer_keeps_the_last_marks(monkeypatch):
    import collections
    monkeypatch.setattr(profiling, "_MARKS", collections.deque(maxlen=3))
    for i in range(5):
        with profiling.span(f"s{i}", always=True):
            pass
    assert names() == ["s2", "s3", "s4"]


def test_setup_spans_of_assets_and_weights(small_model):
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.serving import serving_weights
    build_assets("human36", data_dirs=[], synthetic_vertex_num=890, seed=0)
    serving_weights(small_model[2], torch.float32, use_kernels=False)
    assert names() == ["setup.assets", "setup.fold"]


def test_trace_writes_the_spans_on_its_own_clock(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        with profiling.span("work"):
            t_in = time.time_ns()
            torch.ones(32, 32) @ torch.ones(32, 32)
    with profiling.span("after"):
        pass
    with open(osp.join(log_dir, "trace.json")) as f:
        data = json.load(f)
    base = int(data["baseTimeNanoseconds"])
    spans = {e["name"]: e for e in data["traceEvents"]
             if e.get("cat") == profiling.SPAN_CAT}
    assert set(spans) == {"work", "trace"}           # the window's alone
    mark = dict((m[0], m) for m in profiling.marks())["work"]
    work, window = spans["work"], spans["trace"]
    assert work["ts"] * 1e3 + base == pytest.approx(mark[1], abs=1e3)
    assert work["dur"] * 1e3 == pytest.approx(mark[2] - mark[1], abs=1e3)
    t = (t_in - base) / 1e3
    assert work["ts"] <= t <= work["ts"] + work["dur"]
    assert window["ts"] <= work["ts"]
    assert work["ts"] + work["dur"] <= window["ts"] + window["dur"]
    # the profiler's own host events sit on the same clock, in the span
    mm = [e for e in data["traceEvents"] if e.get("name") == "aten::mm"]
    assert mm and all(work["ts"] <= e["ts"] <= work["ts"] + work["dur"]
                      for e in mm)


# -- attribute ----------------------------------------------------------------

def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_attribute_on_a_synthetic_trace():
    """Window 0..100 us; spans a (twice: 10..40 and 92..96), a.in (inside
    the first a) and b; four runtime calls, three of them launches, each
    with its device operation by correlation id."""
    span = profiling.SPAN_CAT
    events = [
        _ev(span, "trace", 0, 100), _ev(span, "a", 10, 30),
        _ev(span, "a.in", 20, 10), _ev(span, "b", 50, 40),
        _ev(span, "a", 92, 4),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 25, 1, 2),
        _ev("cuda_driver", "cuLaunchKernel", 55, 1, 3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 60, 1, 4),
        _ev("cuda_runtime", "cudaStreamSynchronize", 93, 2),
        _ev("kernel", "k1", 15, 5, 1), _ev("kernel", "k2", 30, 15, 2),
        _ev("kernel", "k3", 60, 10, 3), _ev("gpu_memcpy", "HtoD", 72, 3, 4),
        _ev("cpu_op", "aten::mm", 11, 3),
    ]
    got = profiling.attribute({"traceEvents": events,
                               "baseTimeNanoseconds": 0})
    # idle gaps: 0..15, 20..30, 45..60, 70..72, 75..100
    assert got["trace"] == pytest.approx({
        "calls": 1, "host_ms": 0.1, "launches": 3, "device_ms": 0.033,
        "idle_ms": 0.067})
    assert got["a"] == pytest.approx({
        "calls": 2, "host_ms": 0.034, "launches": 2, "device_ms": 0.020,
        "idle_ms": 0.010})
    assert got["a.in"] == pytest.approx({
        "calls": 1, "host_ms": 0.010, "launches": 1, "device_ms": 0.015,
        "idle_ms": 0.010})
    assert got["b"] == pytest.approx({
        "calls": 1, "host_ms": 0.040, "launches": 1, "device_ms": 0.013,
        "idle_ms": 0.027})


# -- the benchmark readers' placement ----------------------------------------

BASE = 1_700_000_000_000_000_000


def _traced_run():
    """Two benchmark calls (trace us) with the device busy 110..150 and
    160..190 in the first, 310..340 and 345..390 in the second; the
    program's serve spans open 4 and 6 us after the calls', on the wall
    clock (ns); two set-up spans overlap by 0.5 s."""
    from benchmark.core.trace import Trace
    spans = [(100.0, 200.0, "serve_call"), (190.0, 200.0, "sync"),
             (300.0, 400.0, "serve_call"), (395.0, 400.0, "sync")]
    device = [(110.0, 150.0, "k"), (160.0, 190.0, "k"), (310.0, 340.0, "k"),
              (345.0, 390.0, "k")]
    tr = Trace(device=device, spans=spans, window=(90.0, 410.0))
    us = 1000

    def mark(name, a, b):
        return (name, BASE + int(a * us), BASE + int(b * us))

    marks = [mark("setup.assets", -5e6, -4e6), mark("setup.kernels",
                                                      -4.5e6, -3e6),
             mark("serve.k1", 108, 120), mark("serve", 104, 185),
             mark("serve.k1", 310, 320), mark("serve", 306, 380)]
    return tr, marks


def test_placement_pairs_the_kth_serve_with_the_kth_call():
    from benchmark.metrics import program_marks
    tr, marks = _traced_run()
    # the trace's clock is the marks' less BASE: the least lag (4 us) is
    # the offset's error
    spans = program_marks.placed(tr, [(n, a - BASE, b - BASE)
                                      for n, a, b in marks])
    by = {}
    for a, b, n in spans:
        by.setdefault(n, []).append((a, b))
    assert by["serve"] == [pytest.approx((100.0, 181.0)),
                           pytest.approx((302.0, 376.0))]
    assert by["serve.k1"][0] == pytest.approx((104.0, 116.0))
    assert program_marks.placed(tr, marks[:-1]) is None   # 1 mark, 2 calls
    assert program_marks.placed(tr, []) is None
    assert program_marks.placed(tr, None) is None


def test_readers_of_the_program_spans(monkeypatch):
    from benchmark.core import spec
    from benchmark.metrics import program_marks
    tr, marks = _traced_run()
    monkeypatch.setattr(program_marks, "program_marks", lambda: marks)
    layer = {"trace": tr, "traced_calls": 2}
    read = {n: spec.metric_reader(n).read(layer) for n in (
        "serve_dispatch_ms", "serve_dispatch_idle_ms", "setup_program_s")}
    # serve spans placed at 100..181 and 302..376; the gaps 150..160 and
    # 340..345 open inside them, 90..110, 190..310 (in the sync, into the
    # next call) and 390..410 outside
    assert read["serve_dispatch_ms"] == pytest.approx((81 + 74) / 2 / 1e3)
    assert read["serve_dispatch_idle_ms"] == pytest.approx(15 / 2 / 1e3)
    assert read["setup_program_s"] == pytest.approx(2.0)     # the union
    monkeypatch.setattr(program_marks, "program_marks", lambda: None)
    assert all(spec.metric_reader(n).read(layer) is None for n in read)


# -- the program's spans --------------------------------------------------------

def test_cpu_serving_call_records_its_stages_in_order(small_model):
    from gator_tpu_torch.serving import make_serving_fn
    serve = make_serving_fn(small_model[2], torch.float32)
    x = torch.randn(3, 17, 2)
    serve(x)                                       # no profiler: no marks
    assert names() == ["setup.fold"]
    profiling.clear_marks()
    with cpu_profile():
        serve(x)
    got = sorted(profiling.marks(), key=lambda m: m[1])
    assert [m[0] for m in got] == ["serve"] + STAGES
    _, s0, s1 = got[0]
    ends = [s0]
    for _, a, b in got[1:]:
        assert ends[-1] <= a <= b <= s1
        ends.append(b)


def _stage2(small_model):
    from gator_tpu_torch.tools import exp_train_ablate as eta
    from gator_tpu_torch.train import (Adam, TrainState,
                                       make_gator_train_step)
    assets, spec, model = small_model
    state = TrainState(model, Adam(model.parameters(), lr=1e-5))
    step = make_gator_train_step(spec, assets.faces, assets.j_regressor_h36m,
                                 losses.LossWeights(), dtype=torch.float32)
    return state, step, eta.make_batch(4, 17, spec.mdr.full_num)


def _stage1(small_model):
    from gator_tpu_torch.train import Adam, TrainState, make_gat_train_step
    _, spec, model = small_model
    gat = model.pose_lifter
    state = TrainState(gat, Adam(gat.parameters(), lr=1e-5))
    rng = np.random.default_rng(0)
    batch = {"pose2d": rng.normal(size=(4, 17, 2)).astype(np.float32),
             "joint_cam": rng.normal(0, 100, (4, 17, 3)).astype(np.float32),
             "joint_valid": np.ones((4, 17, 1), np.float32)}
    return state, make_gat_train_step(gat.spec), batch


@pytest.mark.parametrize("stage", [_stage2, _stage1])
def test_cpu_train_step_records_its_spans(small_model, stage):
    from gator_tpu_torch.data.device_pipeline import with_assembly
    state, step, batch = stage(small_model)
    wrapped = with_assembly(step, lambda state, batch, *extra: batch)
    wrapped(state, batch, 5)
    assert names() == []
    with cpu_profile():
        wrapped(state, batch, 5)
    got = sorted(profiling.marks(), key=lambda m: m[1])
    assert [m[0] for m in got] == [
        "step.assemble", "step.forward", "step.loss", "step.backward",
        "step.allreduce", "step.optimizer"]
    for (_, _, b), (_, a, _) in zip(got, got[1:]):
        assert b <= a
