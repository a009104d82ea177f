"""Mesh export and the loss plot (counterpart of gator_tpu/vis.py:20
`save_obj` and :73 `save_loss_plot`; reference: lib/funcs_utils.py:51-57,
130-150). The overlays, the 3D pose plot and the renderers of the JAX
package's vis.py are not ported yet."""
from __future__ import annotations

import numpy as np


def save_obj(verts: np.ndarray, faces: np.ndarray, path: str):
    """Write [V, 3] vertices and [F, 3] 0-based faces as Wavefront .obj."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:f} {v[1]:f} {v[2]:f}\n")
        for face in faces + 1:   # 1-indexed
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def save_loss_plot(values, path: str, title: str = "Train Loss") -> bool:
    """Plot the per-epoch loss curve to `path` -> True, or, where
    matplotlib is not installed (the card's machine has none), write
    nothing and -> False. The plot is a convenience: the same history is
    in every checkpoint's `train_log`. This is a missing optional
    dependency, not a fallback of any computation."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(np.arange(1, len(values) + 1), values)
    ax.set_xlabel("epoch")
    ax.set_title(title)
    fig.savefig(path)
    plt.close(fig)
    return True
