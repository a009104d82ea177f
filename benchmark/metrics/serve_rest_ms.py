"""Device ms a serving call outside K1 and K2: the embeds, the hop/path
bias's use, the MDR tokens, the head and the upsample (plain torch in
`serving`)."""
from benchmark.core import trace

KERNELS = r"\b(gat_trunk_kernel|rows_kernel|lbf_selfattn_kernel)\b"


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not tr.device:
        return None
    return 1e3 * trace.seconds_outside(tr, KERNELS) / layer["traced_calls"]
