"""The whole serving call's share of the card's bf16 peak: the model's
forward products per pose (benchmark/core/counts.py: every GAT, LBF, head
and upsample product once; the hop/path bias, which no pose changes, left
out) times the poses a second of the run's measured window, over 989
TFLOP/s, in %. The count does not depend on what implements the model."""
from benchmark.core import counts


def read(layer: dict):
    pps = layer.get("poses_per_s")
    if not pps:
        return None
    d = counts.dims(layer["cfg"])
    return 100.0 * counts.model_forward(d) * pps / counts.PEAK_BF16_FLOPS
