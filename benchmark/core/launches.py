"""Each device operation of a chrome trace matched to the runtime call that
launched it, by the profiler's correlation ids, so that device time can be
charged to the program span in which its launch was made (the host's
span, not the device's clock, says which stage an operation belongs to).
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, Tuple

from .trace import DEVICE_CATS
from benchmark.metrics import program_marks

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def read(path: str, window: Tuple[float, float]) -> Dict[str, list]:
    """-> {"calls": [(ts us, correlation)] of the runtime and driver calls,
    "device": [(start us, end us, name, correlation)] of the device
    operations, clipped to `window` (trace us)} from a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    w0, w1 = window
    calls, device = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        corr = e.get("args", {}).get("correlation")
        t0 = float(e["ts"])
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            calls.append((t0, corr))
        elif e.get("cat") in DEVICE_CATS:
            t1 = t0 + float(e["dur"])
            if t1 > w0 and t0 < w1:
                device.append((max(t0, w0), min(t1, w1),
                               str(e.get("name", "")), corr))
    return {"calls": sorted(calls), "device": sorted(device)}


def launched_in(info: Dict[str, list],
                spans: Iterable[Tuple[float, float]]) -> set:
    """The correlation ids of the calls made inside any of `spans`
    (trace us)."""
    spans = list(spans)
    return {corr for t, corr in info["calls"]
            if any(a <= t < b for a, b in spans)}


def device_us(info: Dict[str, list], corrs: set) -> float:
    """Device microseconds of the operations those calls launched."""
    return sum(b - a for a, b, _, corr in info["device"] if corr in corrs)


def span_corrs(layer: dict, span: str):
    """The correlation ids of the calls made inside the program's spans
    named `span` over a traced run (`layer`'s trace and launches, the
    spans placed by program_marks), or None where the trace, the launches
    or the spans are missing."""
    tr, info = layer.get("trace"), layer.get("launches")
    if tr is None or not info:
        return None
    spans = program_marks.placed(tr, program_marks.program_marks())
    inside = [(a, b) for a, b, name in spans or () if name == span]
    if not inside:
        return None
    return launched_in(info, inside)
