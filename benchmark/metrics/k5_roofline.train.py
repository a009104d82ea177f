"""K5, the GAT trunk's training kernels (`gat_block_fwd`, `gat_block_bwd`,
`gat_block_wgrad`, `reduce_partials_kernel`; six blocks a step): the
least time the card could take for the trunk's forward products and, for
each, its input-gradient and weight-gradient products (3x the forward;
nothing recomputed), at the cell's per-card batch and joint count, over
K5's device time a step, in %. Bound by the operations (bf16 at 989
TFLOP/s)."""
from benchmark.core import counts, trace

PATTERN = r"\b(gat_block_(fwd|bwd|wgrad)|reduce_partials_kernel)\b"


def ops_and_bytes(cfg: dict, b: int):
    d = counts.dims(cfg)
    return 3 * counts.gat_trunk(d) * b, counts.k5_bytes(d, b)


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not trace.select(tr, PATTERN):
        return None
    t = trace.seconds(tr, PATTERN) / layer["traced_steps"]
    return counts.roofline_pct(*ops_and_bytes(layer["cfg"], layer["batch"]),
                               t)
