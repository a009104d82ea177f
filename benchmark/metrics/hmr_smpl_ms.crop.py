"""Device ms a call of the operations launched inside the program's
`serve.hmr_smpl` span (models/hmr2.py: SMPL from rotation matrices in f32,
`bodymodel.smpl_forward_rotmat`, for the call's 64 crops), each matched
to its launch by the trace's correlation ids (core/launches.py), the span
placed on the trace's timeline by program_marks."""
from benchmark.core import launches

SPAN = "serve.hmr_smpl"


def read(layer: dict):
    corrs = launches.span_corrs(layer, SPAN)
    if not corrs:
        return None
    return launches.device_us(layer["launches"], corrs) / 1e3 \
        / layer["traced_calls"]
