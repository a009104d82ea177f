"""Mesh export (counterpart of gator_tpu/vis.py:20 `save_obj`; reference:
lib/funcs_utils.py:51-57). The overlays, plots and renderers of the JAX
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
