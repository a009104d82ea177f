"""K3, the fused attention (`attention_kernel`, csrc/fused_attention.cu),
on MotionBERT's serving call: its 20 launches a call (a spatial and a
temporal attention in each of the 10 Blocks), the least time the card
could take for their products and bytes at the cell's batch, over K3's
device time a call, in %. Bound by the bytes (q, k and v read and out
written, 142.6 MB a launch at 128 clips of 16 frames: 0.85 ms a call at
3.35 TB/s); the products take a fortieth of that."""
from benchmark.core import counts, mb_counts, trace

PATTERN = r"\battention_kernel\b"


def ops_and_bytes(cfg: dict, clips: int, t: int):
    d = mb_counts.dims(cfg, t)
    return mb_counts.k3_ops(d, clips), mb_counts.k3_bytes(d, clips)


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not trace.select(tr, PATTERN):
        return None
    s = trace.seconds(tr, PATTERN) / layer["traced_calls"]
    ops, nbytes = ops_and_bytes(layer["cfg"], layer["batch"],
                                layer["clip_len"])
    return counts.roofline_pct(ops, nbytes, s)
