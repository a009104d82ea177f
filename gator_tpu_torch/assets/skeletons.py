"""Joint-set metadata: names, skeletons, flip pairs for every joint set the
framework supports.

These constants mirror the reference's per-dataset attributes
(reference: data/Human36M/dataset.py:44-75, lib/smpl.py:36-49) but live in
one place instead of being re-declared inside every dataset class.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class JointSet:
    name: str
    joint_num: int
    joints_name: Tuple[str, ...]
    skeleton: Tuple[Tuple[int, int], ...]
    flip_pairs: Tuple[Tuple[int, int], ...]
    root_idx: int
    # joints to use when computing MPJPE/PA-MPJPE (H36M protocol); None = all
    eval_joints: Tuple[int, ...] | None = None

    def adjacency(self) -> np.ndarray:
        """Joint adjacency: skeleton edges + flip-pair edges + self loops.

        Mirrors build_adj (reference: lib/graph_utils.py:60-69).
        """
        adj = np.zeros((self.joint_num, self.joint_num), dtype=np.float32)
        for a, b in self.skeleton:
            adj[a, b] = adj[b, a] = 1.0
        for a, b in self.flip_pairs:
            adj[a, b] = adj[b, a] = 1.0
        return adj + np.eye(self.joint_num, dtype=np.float32)


H36M = JointSet(
    name="human36",
    joint_num=17,
    joints_name=(
        "Pelvis", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee", "L_Ankle",
        "Torso", "Neck", "Nose", "Head", "L_Shoulder", "L_Elbow", "L_Wrist",
        "R_Shoulder", "R_Elbow", "R_Wrist",
    ),
    skeleton=(
        (0, 7), (7, 8), (8, 9), (9, 10), (8, 11), (11, 12), (12, 13), (8, 14),
        (14, 15), (15, 16), (0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6),
    ),
    flip_pairs=((1, 4), (2, 5), (3, 6), (14, 11), (15, 12), (16, 13)),
    root_idx=0,
    eval_joints=(1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16),
)

# COCO-19: the 17 COCO keypoints + synthetic pelvis (17) and neck (18)
# (reference: data/Human36M/dataset.py:66-74).
COCO = JointSet(
    name="coco",
    joint_num=19,
    joints_name=(
        "Nose", "L_Eye", "R_Eye", "L_Ear", "R_Ear", "L_Shoulder",
        "R_Shoulder", "L_Elbow", "R_Elbow", "L_Wrist", "R_Wrist", "L_Hip",
        "R_Hip", "L_Knee", "R_Knee", "L_Ankle", "R_Ankle", "Pelvis", "Neck",
    ),
    skeleton=(
        (1, 2), (0, 1), (0, 2), (2, 4), (1, 3), (6, 8), (8, 10), (5, 7),
        (7, 9), (12, 14), (14, 16), (11, 13), (13, 15),
        (17, 11), (17, 12), (17, 18), (18, 5), (18, 6), (18, 0),
    ),
    flip_pairs=((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
                (15, 16)),
    root_idx=17,
)

# SMPL kinematic joint set (24 body joints; reference: lib/smpl.py:37-48 also
# appends nose/eye/ear keypoint rows to reach 29 — see smpl_assets).
SMPL24 = JointSet(
    name="smpl",
    joint_num=24,
    joints_name=(
        "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
        "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
        "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
        "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
    ),
    skeleton=(
        (0, 1), (1, 4), (4, 7), (7, 10), (0, 2), (2, 5), (5, 8), (8, 11),
        (0, 3), (3, 6), (6, 9), (9, 14), (14, 17), (17, 19), (19, 21),
        (21, 23), (9, 13), (13, 16), (16, 18), (18, 20), (20, 22), (9, 12),
        (12, 15),
    ),
    flip_pairs=((1, 2), (4, 5), (7, 8), (10, 11), (13, 14), (16, 17),
                (18, 19), (20, 21), (22, 23)),
    root_idx=0,
)

# GAT prunes these fixed index pairs from the adjacency before using it for
# graph conv / degree embeddings. For H36M they are exactly the flip pairs;
# the reference applies the same hard-coded indices to any joint set
# (reference: lib/models/GAT.py:57-64).
_GAT_PRUNED_PAIRS = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))


def gat_adjacency(joint_set: JointSet) -> np.ndarray:
    """The adjacency GAT actually consumes: build_adj output with the fixed
    symmetric-edge pairs zeroed (reference: lib/models/GAT.py:57-64)."""
    adj = joint_set.adjacency()
    for a, b in _GAT_PRUNED_PAIRS:
        adj[a, b] = adj[b, a] = 0.0
    return adj


BY_NAME = {"human36": H36M, "coco": COCO, "smpl": SMPL24}


def get_joint_set(name: str) -> JointSet:
    try:
        return BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown joint set {name!r}; have {sorted(BY_NAME)}")
