"""The share of the traced window in which no operation ran on the card
(1 minus the union of device intervals over the window), in %."""
from benchmark.core import trace


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / tr.window_s)
