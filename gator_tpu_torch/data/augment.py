"""Augmentation parameters (host numpy, explicit generator; counterpart of
gator_tpu/data/augment.py:140 `augm_params_batch`; reference:
lib/aug_utils.py:98-117). The per-sample 2D/3D transforms are not ported:
the batched forms live in `processing` and `base.assemble_batch`."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def augm_params_batch(is_train: bool, flip_enabled: bool,
                      rotate_factor: float, b: int,
                      rng: np.random.Generator
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(flips [B] int64, rots [B] f32): flip w.p. 0.5 when enabled; rot ~
    clip(N(0, 1) * rf, +-2 rf), zeroed half the time. Three vectorised
    draws, in the JAX package's order, so one generator gives both the same
    numbers. Evaluation draws nothing."""
    if not is_train:
        return np.zeros(b, np.int64), np.zeros(b, np.float32)
    flips = ((rng.uniform(size=b) <= 0.5) & flip_enabled).astype(np.int64)
    rots = np.clip(rng.standard_normal(b) * rotate_factor,
                   -2 * rotate_factor, 2 * rotate_factor)
    rots[rng.uniform(size=b) <= 0.5] = 0.0
    return flips, rots.astype(np.float32)
