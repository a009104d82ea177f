"""True-f32 matrix products on the card.

The JAX package pins `Precision.HIGHEST` wherever a product feeds a target,
a metric or a parity check (gator_tpu/bodymodel/smpl.py:73,
gator_tpu/train/loop.py:139). The counterpart on an NVIDIA card is TF32 off:
TF32 keeps about three decimal digits, O(1) mm on meshes in millimetres.
"""
from __future__ import annotations

import torch


def no_tf32() -> None:
    """Switch TF32 off for cuBLAS matrix products and cuDNN convolutions.
    The flags are process-wide; nothing in the port switches them back on,
    so a step or a synthesis running in another thread never sees TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
