"""Host-side coordinate utilities (numpy; counterpart of
gator_tpu/data/coords.py). Only the per-sample similarity Procrustes is
ported: the batched crop in `processing` inlines the bbox math."""
from __future__ import annotations

import numpy as np


def rigid_align_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Align the [N, 3] points `a` to `b` by a similarity transform, one
    sample on the host: the per-sample form of `metrics.procrustes_align`
    (reference: lib/coord_utils.py:127-149)."""
    n = a.shape[0]
    ca, cb = a.mean(0), b.mean(0)
    h = (a - ca).T @ (b - cb) / n
    u, s, vh = np.linalg.svd(h)
    r = vh.T @ u.T
    if np.linalg.det(r) < 0:
        s[-1] = -s[-1]
        vh[2] = -vh[2]
        r = vh.T @ u.T
    var = np.var(a, axis=0).sum()
    c = s.sum() / var
    t = -(c * r) @ ca + cb
    return (c * r @ a.T).T + t
