"""K4, the LBF stack's training kernels (`lbf_rows_fwd`, `lbf_sa_fwd`,
`lbf_sa_bwd_dq`, `lbf_sa_bwd_dkv`, `lbf_rows_bwd`, `lbf_joints_bwd`,
`lbf_wgrad`, `lbf_reduce`; three layers a step): the least time the card
could take for the stack's forward products and their input- and
weight-gradient products (3x the forward; nothing recomputed), at the
cell's per-card batch and joint count, over K4's device time a step, in
%. Bound by the operations (bf16 at 989 TFLOP/s)."""
from benchmark.core import counts, trace

PATTERN = (r"\blbf_(rows_fwd|sa_fwd|sa_bwd_dq|sa_bwd_dkv|rows_bwd|wgrad|"
           r"joints_bwd|reduce)_kernel\b")


def ops_and_bytes(cfg: dict, b: int):
    d = counts.dims(cfg)
    return 3 * counts.lbf_stack(d) * b, counts.k4_bytes(d, b)


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not trace.select(tr, PATTERN):
        return None
    t = trace.seconds(tr, PATTERN) / layer["traced_steps"]
    return counts.roofline_pct(*ops_and_bytes(layer["cfg"], layer["batch"]),
                               t)
