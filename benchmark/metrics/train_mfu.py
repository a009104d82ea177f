"""The whole training step's share of the cards' bf16 peak: 3x the
model's forward products per pose (benchmark/core/counts.py; nothing
recomputed) times the poses a second of the run's measured window, over
989 TFLOP/s a card, in %. The count does not depend on what implements
the model."""
from benchmark.core import counts


def read(layer: dict):
    pps = layer.get("poses_per_s")
    if not pps:
        return None
    d = counts.dims(layer["cfg"])
    return (100.0 * counts.train_step(d) * pps
            / (counts.PEAK_BF16_FLOPS * layer.get("chips", 1)))
