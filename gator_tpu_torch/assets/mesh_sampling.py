"""Mesh down/up-sampling matrices (6890 -> 1723 -> 431 and back).

The reference loads `mesh_downsampling.npz` (lists of scipy sparse A/U/D
matrices from the Pose2Mesh/GraphCMR lineage) and multiplies them as torch
sparse tensors at runtime (reference: lib/models/backbones/mesh.py:50-123).

Here they are stored **dense** (431x1723 and 1723x6890 are small),
precomputed once at asset-build time. A deterministic synthetic fallback keeps everything testable without
the external npz (SURVEY.md §7 risk: data availability).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshSampling:
    """Two-level mesh resampling operators, dense."""

    down1: np.ndarray   # [V1, V0]  e.g. 1723 x 6890
    down2: np.ndarray   # [V2, V1]  e.g. 431 x 1723
    up1: np.ndarray     # [V0, V1]
    up2: np.ndarray     # [V1, V2]

    def downsample(self, x: np.ndarray) -> np.ndarray:
        """x [..., V0, 3] -> [..., V2, 3] (numpy, asset-build only)."""
        return self.down2 @ (self.down1 @ x)


def _densify(mat) -> np.ndarray:
    if hasattr(mat, "toarray"):
        return np.asarray(mat.toarray(), dtype=np.float32)
    return np.asarray(mat, dtype=np.float32)


def load_mesh_sampling_npz(path: str) -> MeshSampling:
    """Load the standard mesh_downsampling.npz (object arrays A/U/D of scipy
    sparse matrices) into dense operators."""
    data = np.load(path, encoding="latin1", allow_pickle=True)
    d = [_densify(m) for m in data["D"]]
    u = [_densify(m) for m in data["U"]]
    return MeshSampling(down1=d[0], down2=d[1], up1=u[0], up2=u[1])


def synthetic_mesh_sampling(vertex_num: int) -> MeshSampling:
    """Deterministic stand-in: contiguous groups of ~4 vertices averaged per
    level, transpose-style upsampling. Produces the same shapes family as the
    real operators (V, ceil(V/4), ceil(V/16))."""

    def level(v0: int) -> tuple[np.ndarray, np.ndarray]:
        v1 = -(-v0 // 4)
        down = np.zeros((v1, v0), dtype=np.float32)
        for i in range(v1):
            members = np.arange(4 * i, min(4 * i + 4, v0))
            down[i, members] = 1.0 / len(members)
        up = np.zeros((v0, v1), dtype=np.float32)
        for i in range(v1):
            members = np.arange(4 * i, min(4 * i + 4, v0))
            up[members, i] = 1.0
        return down, up

    d1, u1 = level(vertex_num)
    d2, u2 = level(d1.shape[0])
    return MeshSampling(down1=d1, down2=d2, up1=u1, up2=u2)
