"""Device ms a MotionBERT serving call outside K3 and SMPL: the GEMMs,
LayerNorms, GELU, the streams' fusion, the embed, the head and any layout
change (plain torch in models/motionbert.py), the union of those
operations' device intervals over the traced calls. SMPL's operations are
those launched in `serve.mb_smpl`, matched by correlation id
(`core.launches.span_corrs`, as mb_smpl_ms.clip reads them)."""
import re

from benchmark.core import launches, trace

K3 = re.compile(r"\battention_kernel\b")


def read(layer: dict):
    info = layer.get("launches")
    corrs = launches.span_corrs(layer, "serve.mb_smpl")
    if not info or corrs is None:
        return None
    rest = [(a, b) for a, b, name, corr in info["device"]
            if corr not in corrs and not K3.search(name)]
    return trace.union_us(rest) / 1e3 / layer["traced_calls"]
