"""Temporal pose smoothing: the One-Euro filter (counterpart of
gator_tpu/smoothing.py; reference: lib/smooth_utils.py, OneEuroFilter and
smooth_pose, used by the 3DPW acceleration metric). A host numpy filter,
and `one_euro_smooth_torch`, the same filter as a loop over time on the
tensor's device (the JAX package's jitted scan, `one_euro_smooth_jax`).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _smoothing_factor(t_e, cutoff):
    r = 2 * np.pi * cutoff * t_e
    return r / (r + 1)


def one_euro_smooth(seq: np.ndarray, min_cutoff: float = 0.004,
                    beta: float = 0.7, d_cutoff: float = 1.0,
                    fps: float = 1.0) -> np.ndarray:
    """Smooth a [T, ...] sequence with the One-Euro filter (host numpy)."""
    te = 1.0 / fps
    x_prev = seq[0].astype(np.float64)
    dx_prev = np.zeros_like(x_prev)
    out = [seq[0]]
    for t in range(1, len(seq)):
        x = seq[t].astype(np.float64)
        a_d = _smoothing_factor(te, d_cutoff)
        dx = (x - x_prev) / te
        dx_hat = a_d * dx + (1 - a_d) * dx_prev
        cutoff = min_cutoff + beta * np.abs(dx_hat)
        a = _smoothing_factor(te, cutoff)
        x_hat = a * x + (1 - a) * x_prev
        out.append(x_hat.astype(seq.dtype))
        x_prev, dx_prev = x_hat, dx_hat
    return np.stack(out)


def one_euro_smooth_torch(seq: torch.Tensor, min_cutoff: float = 0.004,
                          beta: float = 0.7, d_cutoff: float = 1.0
                          ) -> torch.Tensor:
    """The same filter on a [T, ...] tensor, in its dtype on its device, one
    step of the recurrence per frame (fps = 1)."""
    r_d = 2 * math.pi * d_cutoff
    a_d = r_d / (r_d + 1)
    x_prev, dx_prev = seq[0], torch.zeros_like(seq[0])
    out = [seq[0]]
    for x in seq[1:]:
        dx_hat = a_d * (x - x_prev) + (1 - a_d) * dx_prev
        r = 2 * math.pi * (min_cutoff + beta * dx_hat.abs())
        a = r / (r + 1)
        x_prev, dx_prev = a * x + (1 - a) * x_prev, dx_hat
        out.append(x_prev)
    return torch.stack(out)
