"""Device ms a call of the operations launched inside the program's
`serve.mb_smpl` span (models/motionbert.py: the SPIN 6D rotations, SMPL
from rotation matrices in f32, the H36M joints), each matched to its
launch by the trace's correlation ids (core/launches.py), the span placed
on the trace's timeline by program_marks."""
from benchmark.core import launches

SPAN = "serve.mb_smpl"


def read(layer: dict):
    corrs = launches.span_corrs(layer, SPAN)
    if not corrs:
        return None
    return launches.device_us(layer["launches"], corrs) / 1e3 \
        / layer["traced_calls"]
