"""Device ms a call of the operations launched inside the program's
`serve.hmr_decoder` span (models/hmr2.py: the decoder's six layers with
its cross- and self-attentions on K3, the stacked to_kv product, the
readouts, the 6D rotations and the camera), each matched to its launch by
the trace's correlation ids (core/launches.py), the span placed on the
trace's timeline by program_marks."""
from benchmark.core import launches

SPAN = "serve.hmr_decoder"


def read(layer: dict):
    corrs = launches.span_corrs(layer, SPAN)
    if not corrs:
        return None
    return launches.device_us(layer["launches"], corrs) / 1e3 \
        / layer["traced_calls"]
