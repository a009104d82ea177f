"""K2, the LBF stack's serving kernels (`rows_kernel` and
`lbf_selfattn_kernel`, two launches a layer): the least time the card
could take for the three layers' products at the cell's batch and joint
count, over K2's device time a call, in %. Bound by the operations (bf16
at 989 TFLOP/s): the vertex and joint tokens in and out and the weights
take a tenth of that time."""
from benchmark.core import counts, trace

PATTERN = r"\b(rows_kernel|lbf_selfattn_kernel)\b"


def ops_and_bytes(cfg: dict, b: int):
    d = counts.dims(cfg)
    return counts.lbf_stack(d) * b, counts.k2_bytes(d, b)


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not trace.select(tr, PATTERN):
        return None
    t = trace.seconds(tr, PATTERN) / layer["traced_calls"]
    return counts.roofline_pct(*ops_and_bytes(layer["cfg"], layer["batch"]),
                               t)
