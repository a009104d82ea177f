"""Host spans, the device trace, and the readings taken from them.

`Spans` times the benchmark's own spans on the host clock (the step call,
the wait for the next batch, the serving call); while a device trace is
taken it also keeps each span's wall-clock interval (time.time_ns, the
clock the profiler's trace is based on), so that an idle gap of the device
can be labelled by what the host was doing.

`traced(path)` runs torch.profiler with CUDA activity only (recording
every host-side operator as well would double a training step's host
time and read as idle device) and writes its chrome trace; `read_trace`
puts its device intervals and the benchmark's spans on one timeline.
Every reading is of the span "window": busy time is the union of device
intervals in it, not a sum, so that overlapping operations count once.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[float, float, str]          # (start us, end us, name)


class Spans:
    """Host-clock spans of the benchmark, kept in memory: seconds by name,
    and while `tracing`, (name, start ns, end ns) on the wall clock."""

    def __init__(self):
        self.tracing = False
        self.times: Dict[str, List[float]] = {}
        self.marks: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        w0 = time.time_ns() if self.tracing else 0
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
            if self.tracing:
                self.marks.append((name, w0, time.time_ns()))


@contextlib.contextmanager
def traced(path: str):
    """torch.profiler (CUDA activity) over the block; the chrome trace is
    written to `path` when it closes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof
    torch.cuda.synchronize()
    prof.export_chrome_trace(path)


@dataclass
class Trace:
    device: List[Interval] = field(default_factory=list)
    spans: List[Interval] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


def parse_events(events: List[dict], marks=(), base_ns: int = 0) -> Trace:
    """Chrome-trace events and the benchmark's spans (wall-clock ns; the
    trace's times are microseconds from `base_ns`) -> device intervals and
    spans on the trace's timeline, clipped to the window span."""
    dev = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat", "") in DEVICE_CATS:
            t0 = float(e["ts"])
            dev.append((t0, t0 + float(e["dur"]), str(e.get("name", ""))))
    spans = [((a - base_ns) / 1e3, (b - base_ns) / 1e3, n)
             for n, a, b in marks]
    wins = [s for s in spans if s[2] == "window"]
    if len(wins) != 1:
        raise ValueError(f"trace has {len(wins)} window spans, not one")
    w0, w1 = wins[0][:2]
    clipped = [(max(a, w0), min(b, w1), n) for a, b, n in dev
               if b > w0 and a < w1]
    inner = [s for s in spans if s[2] != "window"]
    return Trace(sorted(clipped), sorted(inner), (w0, w1))


def read_trace(path: str, marks, remove: bool = True) -> Trace:
    with open(path) as f:
        data = json.load(f)
    if remove:
        os.remove(path)
    return parse_events(data["traceEvents"], marks,
                        int(data.get("baseTimeNanoseconds", 0)))


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b, *_ in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def busy_s(tr: Trace) -> float:
    return union_us(tr.device) * 1e-6


def select(tr: Trace, pattern: str) -> List[Interval]:
    """Device intervals whose name matches `pattern` (a regular
    expression searched in the profiler's name)."""
    rx = re.compile(pattern)
    return [iv for iv in tr.device if rx.search(iv[2])]


def seconds(tr: Trace, pattern: str) -> float:
    """Device seconds of the operations matching `pattern` (their
    union)."""
    return union_us(select(tr, pattern)) * 1e-6


def seconds_outside(tr: Trace, pattern: str) -> float:
    """Device seconds of every operation that does not match
    `pattern`."""
    rx = re.compile(pattern)
    return union_us([iv for iv in tr.device if not rx.search(iv[2])]) * 1e-6


def short_name(name: str, limit: int = 160) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name[:limit]


def top_ops(tr: Trace, n: int = 10) -> List[List]:
    """The n device operations with the most time in the window."""
    tot: Dict[str, float] = {}
    for a, b, name in tr.device:
        k = short_name(name)
        tot[k] = tot.get(k, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:n]]


def idle_gaps(tr: Trace) -> List[Tuple[float, float]]:
    """The window's idle intervals (no device operation running)."""
    w0, w1 = tr.window
    gaps, end = [], w0
    for a, b, _ in sorted(tr.device):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


def span_at(tr: Trace, t: float) -> str:
    """The innermost benchmark span in progress at time t on the host."""
    best = None
    for a, b, name in tr.spans:
        if a <= t < b and (best is None or a >= best[0]):
            best = (a, b, name)
    return best[2] if best else "outside_spans"


def idle_by_span(tr: Trace, n: int = 10) -> List[List]:
    """Idle seconds of the window, summed by the benchmark span in
    progress where each gap starts, largest first."""
    tot: Dict[str, float] = {}
    for a, b in idle_gaps(tr):
        k = span_at(tr, a)
        tot[k] = tot.get(k, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:n]]


def breakdown(tr: Trace) -> Dict[str, List[List]]:
    return {"device_ops": top_ops(tr), "idle_gaps": idle_by_span(tr)}
