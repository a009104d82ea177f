"""Profiling and observability (counterpart of gator_tpu/profiling.py): the
program's spans, a `torch.profiler` trace written as a Chrome/Perfetto
trace file with the spans in it, the attribution of a trace's launches,
kernels and device idle to the spans, and the cards' memory statistics.

Spans. `span(name)` marks a stage of the program with
(name, start ns, end ns) on `time.time_ns()`, the wall clock on which
torch.profiler's chrome trace is based (an event's `ts` in microseconds
plus the trace's `baseTimeNanoseconds`). A hot-path span records only
while a torch.profiler session runs in the process, which torch flags in
`torch.autograd.profiler._is_profiler_enabled` for any set of activities;
otherwise it costs that one check. Set-up spans (`span(name,
always=True)`) are cold and always record. The marks sit in a bounded
buffer: `marks()` reads it, `clear_marks()` empties it.

The spans and what reads them:
  serve, serve.gat_embed, serve.k1, serve.gat_head, serve.mdr_tokens,
  serve.k2, serve.head, serve.upsample   (serving.make_serving_fn)
  setup.assets (assets.build_assets), setup.kernels (nn.cuda_lib.load's
  first load of a library, its nvcc build included), setup.fold
  (serving.serving_weights)
  step.assemble, step.noise, step.gt     (the train steps' input wrappers)
  step.forward, step.loss, step.backward, step.allreduce, step.optimizer
                                         (train.make_*_train_step)
  trace                                  (the window of `trace`)
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import os.path as osp
import time
from typing import Dict, List, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

Mark = Tuple[str, int, int]             # (name, start ns, end ns)

MAX_MARKS = 1 << 16
_MARKS: "collections.deque[Mark]" = collections.deque(maxlen=MAX_MARKS)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "gator_span"


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        _MARKS.append((self.name, self.t0, time.time_ns()))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, always: bool = False):
    """A context manager that records (name, start ns, end ns) while a
    torch.profiler session runs, or always with `always=True` (set-up)."""
    if always or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def marks() -> List[Mark]:
    """The recorded marks in the order they ended (the buffer keeps the
    last MAX_MARKS)."""
    return list(_MARKS)


def clear_marks() -> None:
    _MARKS.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the host and, where there is a card, the device, and write the
    trace to `log_dir`/trace.json (Perfetto or chrome://tracing), with the
    spans recorded in the block as host events of their own track on the
    trace's clock:

        with profiling.trace("build/trace"):
            train_step(...)

    Yields the torch.profiler session. The block's window is itself the
    span `trace`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with span("trace") as window:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = osp.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    # the trace's times are microseconds from its baseTimeNanoseconds
    base = int(data.get("baseTimeNanoseconds", 0))
    data["traceEvents"].extend(
        {"ph": "X", "cat": SPAN_CAT, "name": name, "ts": (a - base) / 1e3,
         "dur": (b - a) / 1e3, "pid": os.getpid(),
         "tid": "gator_tpu_torch spans"}
        for name, a, b in marks() if a >= window.t0)
    with open(path, "w") as f:
        json.dump(data, f)


def _union_gaps(busy: List[Tuple[float, float]], w0: float, w1: float
                ) -> List[Tuple[float, float]]:
    """The intervals of [w0, w1] that no busy interval covers."""
    gaps, end = [], w0
    for a, b in sorted(busy):
        if a > end:
            gaps.append((end, min(a, w1)))
        end = max(end, b)
        if end >= w1:
            break
    if w1 > end:
        gaps.append((end, w1))
    return [(a, b) for a, b in gaps if b > a]


def attribute(trace_data: dict) -> Dict[str, dict]:
    """A CPU+CUDA chrome trace that `trace` wrote (its spans inside) ->
    {span name: {"calls", "host_ms", "launches", "device_ms", "idle_ms"}},
    each summed over the span's calls:
      host_ms    the spans' own durations;
      launches   the launch events (a cuda_runtime or cuda_driver call
                 with "Launch" in its name) that start inside the span;
      device_ms  the device time of the kernels, copies and sets that
                 the span's runtime and driver calls enqueued (matched by
                 correlation id);
      idle_ms    the device idle that opens while the span runs: the gaps
                 in the union of device intervals over the `trace` window
                 whose start lies in the span.
    A span nested in another counts in both."""
    events = [e for e in trace_data["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("cat") == SPAN_CAT]
    calls = [(float(e["ts"]), e) for e in events
             if e.get("cat") in LAUNCH_CATS]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    device_us: Dict[int, float] = collections.defaultdict(float)
    for e in device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            device_us[corr] += float(e["dur"])
    windows = [s for s in spans if s[2] == "trace"]
    w0 = min((s[0] for s in windows), default=0.0)
    w1 = max((s[1] for s in windows), default=0.0)
    busy = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in device]
    gaps = _union_gaps(busy, w0, w1)

    calls.sort(key=lambda c: c[0])
    call_ts = [t for t, _ in calls]
    gap_ts = [g0 for g0, _ in gaps]
    out: Dict[str, dict] = {}
    for a, b, name in spans:
        got = out.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                    "launches": 0, "device_ms": 0.0,
                                    "idle_ms": 0.0})
        got["calls"] += 1
        got["host_ms"] += (b - a) / 1e3
        for _, e in calls[bisect.bisect_left(call_ts, a):
                          bisect.bisect_left(call_ts, b)]:
            if "Launch" in e.get("name", ""):
                got["launches"] += 1
            got["device_ms"] += device_us.get(
                e.get("args", {}).get("correlation"), 0.0) / 1e3
        got["idle_ms"] += sum(g1 - g0 for g0, g1 in gaps[
            bisect.bisect_left(gap_ts, a):bisect.bisect_left(gap_ts, b)]
        ) / 1e3
    return out


def device_memory_stats() -> dict:
    """{"cuda:i (name)": torch.cuda.memory_stats(i)} for each visible card;
    {} where there is none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i} ({torch.cuda.get_device_name(i)})":
            torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
