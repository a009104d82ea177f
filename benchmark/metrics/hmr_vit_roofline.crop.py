"""HMR 2.0's backbone (the patch embed, the 32 ViT-H blocks and
last_norm: models/hmr2.py, spans serve.hmr_patch and serve.hmr_vit) on
the crop cell: the least time the card could take for its counted
products and bytes at the cell's batch (core/hmr2_counts.py: 247.9 GFLOP
a crop, 15.9 TFLOP a call of 64 crops, 16.0 ms at 989 TFLOP/s; its bf16
weights, the crops and the tokens 1.3 GB, 0.39 ms at 3.35 TB/s), over the
device time a call of every operation launched inside those two spans
(matched by correlation id, core/launches.span_corrs: the GEMMs, K3, the
LayerNorms, GELU, the adds and the conv), in %."""
from benchmark.core import counts, hmr2_counts, launches

SPANS = ("serve.hmr_patch", "serve.hmr_vit")


def read(layer: dict):
    corrs = [launches.span_corrs(layer, s) for s in SPANS]
    if any(not c for c in corrs):
        return None
    s = launches.device_us(layer["launches"], set().union(*corrs)) / 1e6 \
        / layer["traced_calls"]
    d = hmr2_counts.dims(layer["cfg"])
    b = layer["batch"]
    return counts.roofline_pct(b * hmr2_counts.backbone(d),
                               hmr2_counts.backbone_bytes(d, b), s)
