"""K3, the fused attention (both kernels are named `attention_kernel`,
csrc/fused_attention.cu), on HMR 2.0's serving call: its 44 launches a
call (the backbone's 32 self-attentions over 192 patch tokens, 16 heads
of 80, on the tiled kernel; the decoder's 6 cross-attentions of one query
against the 192 tokens, tiled, and 6 one-token self-attentions, short;
8 heads of 64), the least time the card could take for their products
and bytes at the cell's batch, over K3's device time a call, in %. Bound
by the bytes (q, k and v read and out written: 125.8 MB a backbone
launch at 64 crops, 4.18 GB a call, 1.25 ms at 3.35 TB/s); the products
take a fifth of that."""
from benchmark.core import counts, hmr2_counts, trace

PATTERN = r"\battention_kernel\b"


def ops_and_bytes(cfg: dict, crops: int):
    d = hmr2_counts.dims(cfg)
    return hmr2_counts.k3_ops(d, crops), hmr2_counts.k3_bytes(d, crops)


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not trace.select(tr, PATTERN):
        return None
    s = trace.seconds(tr, PATTERN) / layer["traced_calls"]
    ops, nbytes = ops_and_bytes(layer["cfg"], layer["batch"])
    return counts.roofline_pct(ops, nbytes, s)
