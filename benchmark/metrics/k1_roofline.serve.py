"""K1, the GAT trunk's serving kernel (`gat_trunk_kernel`, one launch a
call): the least time the card could take for the six blocks' products
at the cell's batch and joint count, over K1's device time a call, in %.
Bound by the operations (bf16 at 989 TFLOP/s): the bytes, x in and out
and the weights, take a tenth of that time."""
from benchmark.core import counts, trace

PATTERN = r"\bgat_trunk_kernel\b"


def ops_and_bytes(cfg: dict, b: int):
    d = counts.dims(cfg)
    return counts.gat_trunk(d) * b, counts.k1_bytes(d, b)


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not trace.select(tr, PATTERN):
        return None
    t = trace.seconds(tr, PATTERN) / layer["traced_calls"]
    return counts.roofline_pct(*ops_and_bytes(layer["cfg"], layer["batch"]),
                               t)
