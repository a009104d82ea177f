"""MotionBERT's whole serving call's share of the card's bf16 peak: the
model's products a frame (core/mb_counts.py: the DSTformer's 85.1 MFLOP a
token over 17 joints, the head's 19.2 MFLOP and SMPL's 14.8 MFLOP a
frame, 1.48 GFLOP; the f32 SMPL counted against the same peak) times the
frames a second of the run's measured window, over 989 TFLOP/s, in %."""
from benchmark.core import counts, mb_counts


def read(layer: dict):
    fps = layer.get("frames_per_s")
    if not fps:
        return None
    d = mb_counts.dims(layer["cfg"], layer.get("clip_len"))
    return 100.0 * mb_counts.frame(d) * fps / counts.PEAK_BF16_FLOPS
