"""Ahead-of-time graph precompute for the GAT attention biases.

The reference downloads `shortest_path_{h36m,3dpw}.npy` / `path_{h36m,3dpw}.npy`
and expands them at model-construction time with a Python recursion
(reference: lib/models/GAT.py:89-110, lib/models/backbones/modules.py:6-29).
Here everything is regenerated from the joint adjacency with Floyd–Warshall,
so no external downloads are needed, and the result is a set of dense numpy
tables that the models register as buffers.

Conventions kept for parity with the reference tables:
  * `path[i, j]` holds one intermediate vertex on the shortest i->j path, or
    the sentinel 510 when the edge is direct / i == j
    (reference: lib/models/backbones/modules.py:8,22).
  * bone-length edge features are built from the *upper-triangular* pruned
    adjacency only — a path step from a higher to a lower joint index
    contributes 0, exactly as in the reference loop
    (reference: lib/models/GAT.py:96-110).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import native

PATH_SENTINEL = 510


@dataclasses.dataclass(frozen=True)
class GraphTables:
    """Static per-joint-set tables consumed by the GAT model."""

    adjacency: np.ndarray      # [J, J] pruned adjacency incl. self loops
    degree: np.ndarray         # [J]    int row sums of `adjacency`
    spatial_pos: np.ndarray    # [J, J] int hop distance (0 on diagonal)
    path: np.ndarray           # [J, J] int intermediate vertex or 510
    edge_input: np.ndarray     # [J, J, max_dist] per-hop bone lengths
    hop_recip: np.ndarray      # [J, J] 1 / max(hops - 1, 1)
    masks_xfeat: np.ndarray    # [2, J, J] f32 {hop<=1, hop==2} masks


def floyd_warshall(adjacency: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs hop counts + one-intermediate-vertex path matrix.

    Returns (dist [J,J] int32 with 0 diagonal, path [J,J] int32 with 510
    sentinel for direct edges / diagonal). Raises if the graph (ignoring the
    diagonal) is disconnected — the reference tables assume connectivity.
    """
    j = adjacency.shape[0]
    off = adjacency.copy().astype(np.float64)
    np.fill_diagonal(off, 0.0)
    dist = np.where(off > 0, 1.0, np.inf)
    np.fill_diagonal(dist, 0.0)
    path = np.full((j, j), PATH_SENTINEL, dtype=np.int32)
    for k in range(j):
        through_k = dist[:, k:k + 1] + dist[k:k + 1, :]
        better = through_k < dist
        dist = np.where(better, through_k, dist)
        path = np.where(better, np.int32(k), path)
    if not np.isfinite(dist).all():
        raise ValueError("joint graph is disconnected; hop tables undefined")
    return dist.astype(np.int32), path


def reconstruct_path(path: np.ndarray, i: int, j: int) -> list[int]:
    """Intermediate vertices on the shortest i->j path (may be empty).

    Mirrors get_all_edges (reference: lib/models/backbones/modules.py:6-11).
    """
    k = int(path[i, j])
    if k == PATH_SENTINEL:
        return []
    return reconstruct_path(path, i, k) + [k] + reconstruct_path(path, k, j)


def gen_edge_input(max_dist: int, path: np.ndarray,
                   edge_feat: np.ndarray) -> np.ndarray:
    """Expand the path matrix into per-hop edge features [J, J, max_dist].

    edge_feat[a, b] is the feature of the directed step a->b (here: bone
    length on upper-triangular adjacency entries, 0 elsewhere).
    Mirrors gen_edg_input (reference: lib/models/backbones/modules.py:13-29).
    """
    j = path.shape[0]
    out = np.zeros((j, j, max_dist), dtype=np.float32)
    for a in range(j):
        for b in range(j):
            if a == b or path[a, b] == PATH_SENTINEL:
                continue
            hops = [a] + reconstruct_path(path, a, b) + [b]
            for step in range(len(hops) - 1):
                out[a, b, step] = edge_feat[hops[step], hops[step + 1]]
    return out


def bone_length_matrix(adjacency: np.ndarray,
                       template_joints: np.ndarray) -> np.ndarray:
    """Upper-triangular bone-length matrix over pruned-adjacency edges.

    template_joints: [J, 3] rest-pose joint positions (J_regressor applied to
    the mean mesh). Mirrors the loop at reference: lib/models/GAT.py:96-108.
    """
    j = adjacency.shape[0]
    edg = np.zeros((j, j), dtype=np.float32)
    for a in range(j):
        for b in range(a + 1, j):
            if adjacency[a, b] == 1:
                edg[a, b] = np.linalg.norm(
                    template_joints[a] - template_joints[b])
    return edg


def build_graph_tables(adjacency: np.ndarray,
                       template_joints: np.ndarray,
                       use_native: bool | None = None) -> GraphTables:
    """All static GAT graph tables from a pruned adjacency + template
    joints. `use_native` runs Floyd-Warshall and the edge-input expansion
    in the C++ library (`native`, built on first use); None uses it where
    it is built. The tables are identical either way."""
    adjacency = np.asarray(adjacency, dtype=np.float32)
    if use_native is None:
        use_native = native.available()
    if use_native:
        dist, path = native.floyd_warshall(adjacency, PATH_SENTINEL)
    else:
        dist, path = floyd_warshall(adjacency)
    max_dist = int(dist.max())
    if max_dist >= 10:
        # spatial_pos feeds a 10-entry embedding table
        # (reference: lib/models/GAT.py:112, num_spatial=10)
        raise ValueError(f"graph diameter {max_dist} >= 10 unsupported")
    edge_feat = bone_length_matrix(adjacency, template_joints)
    if use_native:
        edge_input = native.gen_edge_input(max_dist, path, edge_feat,
                                           PATH_SENTINEL)
    else:
        edge_input = gen_edge_input(max_dist, path, edge_feat)
    hops_m1 = np.maximum(dist - 1, 1).astype(np.float32)
    hop_recip = 1.0 / hops_m1
    masks = np.stack([
        (dist <= 1).astype(np.float32),   # 1-ring incl. self
        (dist == 2).astype(np.float32),   # 2-ring
    ])  # X_Feat hop masks (reference: lib/models/backbones/modules.py:163-171)
    degree = adjacency.astype(np.int64).sum(axis=1)
    return GraphTables(
        adjacency=adjacency,
        degree=degree,
        spatial_pos=dist,
        path=path,
        edge_input=edge_input,
        hop_recip=hop_recip,
        masks_xfeat=masks,
    )


def nearest_joint_assignment(template_joints: np.ndarray,
                             vertices: np.ndarray) -> np.ndarray:
    """Nearest template joint index per vertex, [V] int32.

    Mirrors build_verts_joints_relation (reference: lib/graph_utils.py:71-89),
    vectorized.
    """
    d2 = ((vertices[:, None, :] - template_joints[None, :, :]) ** 2).sum(-1)
    return np.argmin(d2, axis=1).astype(np.int32)
