"""HMR 2.0's whole serving call's share of the card's bf16 peak: the
model's products a crop (core/hmr2_counts.py: the ViT-H backbone's 247.9
GFLOP, the decoder's 3.1 GFLOP, the readouts and SMPL; 251 GFLOP; the
f32 SMPL counted against the same peak) times the crops a second of the
run's measured window, over 989 TFLOP/s, in %."""
from benchmark.core import counts, hmr2_counts


def read(layer: dict):
    cps = layer.get("crops_per_s")
    if not cps:
        return None
    d = hmr2_counts.dims(layer["cfg"])
    return 100.0 * hmr2_counts.crop(d) * cps / counts.PEAK_BF16_FLOPS
