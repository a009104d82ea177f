"""The model's derived tables, worked out again from raw data.

Raw data: the joint sets' edge lists (frozen below from kasvii/GATOR's
dataset classes) and the body model's files (the SMPL template, the H36M
and COCO joint regressors and the mesh down-sampling operators: the
counterparts of `smpl_mean_vertices.npy`, `J_regressor_*.npy` and
`mesh_downsampling.npz`). Derived here, as the published code derives
them: the pruned joint adjacency and its degrees (lib/graph_utils.py
build_adj, lib/models/GAT.py:57-64), the hop counts and paths by
Floyd-Warshall and the per-hop bone lengths along them (GAT.py:89-110,
backbones/modules.py:6-29, the sentinel 510 for a direct step), the
X-Feat hop masks (modules.py:163-171), the coarse template (the
down-sampling operators applied to the template) and each coarse vertex's
nearest H36M template joint (graph_utils.py:71-89, MDR.py:85-87).

Plain loops over numpy, written apart from the program's versions; the
CPU tests hold every table against the program's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

SENTINEL = 510

JOINT_SETS = {
    "human36": {
        "joint_num": 17,
        "skeleton": ((0, 7), (7, 8), (8, 9), (9, 10), (8, 11), (11, 12),
                     (12, 13), (8, 14), (14, 15), (15, 16), (0, 1), (1, 2),
                     (2, 3), (0, 4), (4, 5), (5, 6)),
        "flip_pairs": ((1, 4), (2, 5), (3, 6), (14, 11), (15, 12),
                       (16, 13)),
    },
    # the 17 COCO keypoints, then a pelvis (17) between the hips (11, 12)
    # and a neck (18) between the shoulders (5, 6)
    "coco": {
        "joint_num": 19,
        "skeleton": ((1, 2), (0, 1), (0, 2), (2, 4), (1, 3), (6, 8),
                     (8, 10), (5, 7), (7, 9), (12, 14), (14, 16), (11, 13),
                     (13, 15), (17, 11), (17, 12), (17, 18), (18, 5),
                     (18, 6), (18, 0)),
        "flip_pairs": ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                       (13, 14), (15, 16)),
        "pelvis_from": (11, 12),
        "neck_from": (5, 6),
    },
}
# GAT zeroes these index pairs of the adjacency whatever the joint set
PRUNED = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))


def adjacency(name: str) -> np.ndarray:
    js = JOINT_SETS[name]
    j = js["joint_num"]
    adj = np.zeros((j, j), np.float32)
    for a, b in tuple(js["skeleton"]) + tuple(js["flip_pairs"]):
        adj[a, b] = adj[b, a] = 1.0
    for a in range(j):
        adj[a, a] = 1.0
    for a, b in PRUNED:
        adj[a, b] = adj[b, a] = 0.0
    return adj


def floyd_warshall(adj: np.ndarray):
    """-> (hop counts [J, J], one intermediate vertex of each shortest path
    or SENTINEL for a direct step and the diagonal)."""
    j = adj.shape[0]
    inf = float("inf")
    dist = [[0.0 if a == b else (1.0 if adj[a, b] > 0 else inf)
             for b in range(j)] for a in range(j)]
    path = [[SENTINEL] * j for _ in range(j)]
    for k in range(j):
        for a in range(j):
            for b in range(j):
                through = dist[a][k] + dist[k][b]
                if through < dist[a][b]:
                    dist[a][b] = through
                    path[a][b] = k
    if any(d == inf for row in dist for d in row):
        raise ValueError("the joint graph is not connected")
    return np.asarray(dist, np.int64), np.asarray(path, np.int64)


def _between(path: np.ndarray, a: int, b: int) -> List[int]:
    k = int(path[a, b])
    if k == SENTINEL:
        return []
    return _between(path, a, k) + [k] + _between(path, k, b)


def template_joints(name: str, raw: Dict[str, np.ndarray]) -> np.ndarray:
    """The input joint set's joints of the template mesh [J, 3]."""
    mean = raw["template"]
    if name == "human36":
        return raw["j_regressor_h36m"] @ mean
    js = JOINT_SETS[name]
    base = raw["j_regressor_coco"] @ mean
    (lh, rh), (ls, rs) = js["pelvis_from"], js["neck_from"]
    extra = np.stack([0.5 * (base[lh] + base[rh]),
                      0.5 * (base[ls] + base[rs])])
    return np.concatenate([base, extra])


def edge_input(dist, path, adj, joints) -> np.ndarray:
    """[J, J, max hops]: the bone length of each step along the path; a
    step's length counts only from the lower joint index to the higher."""
    j = adj.shape[0]
    bone = np.zeros((j, j), np.float32)
    for a in range(j):
        for b in range(a + 1, j):
            if adj[a, b] == 1:
                bone[a, b] = np.linalg.norm(joints[a] - joints[b])
    out = np.zeros((j, j, int(dist.max())), np.float32)
    for a in range(j):
        for b in range(j):
            if a == b or path[a, b] == SENTINEL:
                continue
            walk = [a] + _between(path, a, b) + [b]
            for s in range(len(walk) - 1):
                out[a, b, s] = bone[walk[s], walk[s + 1]]
    return out


def nearest_joint(joints: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """Each vertex's nearest joint (the first on a tie) [V]."""
    out = np.zeros(len(verts), np.int64)
    for i, v in enumerate(verts):
        out[i] = int(np.argmin(((joints - v[None]) ** 2).sum(-1)))
    return out


def raw_of(assets) -> Dict[str, np.ndarray]:
    """The raw files of an asset bundle: the body model's template and
    faces, the joint regressors, the mesh down-sampling operators."""
    f32 = lambda a: np.asarray(a, np.float32)               # noqa: E731
    return {"template": f32(assets.smpl.v_template),
            "j_regressor_h36m": f32(assets.j_regressor_h36m),
            "j_regressor_coco": f32(assets.j_regressor_coco),
            "down1": f32(assets.sampling.down1),
            "down2": f32(assets.sampling.down2)}


def derive(name: str, raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every table the reference model reads, for input joint set `name`."""
    adj = adjacency(name)
    dist, path = floyd_warshall(adj)
    if dist.max() >= 10:
        raise ValueError("the hop embedding has 10 entries")
    coarse = raw["down2"] @ (raw["down1"] @ raw["template"])
    h36m = template_joints("human36", raw)
    return {
        "adjacency": adj,
        "degree": adj.astype(np.int64).sum(1),
        "spatial_pos": dist,
        "edge_input": edge_input(dist, path, adj,
                                 template_joints(name, raw)),
        "hop_recip": (1.0 / np.maximum(dist - 1, 1)).astype(np.float32),
        "masks_xfeat": np.stack([(dist <= 1), (dist == 2)]).astype(
            np.float32),
        "init_verts_coarse": coarse.astype(np.float32),
        "init_verts_full": raw["template"],
        "vj_relation": nearest_joint(h36m, coarse),
    }
