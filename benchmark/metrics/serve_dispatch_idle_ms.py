"""Device-idle ms a serving call whose gap opens while the host is inside
the program's `serve` span (the card waits for the call's dispatch), over
the traced calls. The rest of the window's idle opens in the benchmark's
sync and between calls."""
from benchmark.core import trace
from benchmark.metrics import program_marks


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not tr.device:
        return None
    spans = program_marks.placed(tr, program_marks.program_marks())
    if spans is None:
        return None
    serve = [(a, b) for a, b, name in spans if name == "serve"]
    idle_us = sum(g1 - g0 for g0, g1 in trace.idle_gaps(tr)
                  if any(a <= g0 < b for a, b in serve))
    return idle_us / 1e3 / layer["traced_calls"]
