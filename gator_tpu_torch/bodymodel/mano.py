"""MANO hand model on tensors (counterpart of gator_tpu/bodymodel/mano.py;
reference: manopth/manopth/manolayer.py:12-273, lib/_mano.py:10-33):
16-joint kinematic hand, optional PCA pose space (full pose = root +
hands_mean + coeffs @ components), and a 21-joint regressor with the
fingertip one-hots reordered Wrist, Thumb..Pinky. Past the PCA step the
hand is SMPL's machinery with other tables, so `mano_forward` runs the
port's `smpl_forward` (blendshapes, the kinematic chain level by level,
linear blend skinning) on a `ManoParams`, which is an `SmplParams`. The
rot6d / SVD projection utilities of manopth are in `rotations6d`.
"""
from __future__ import annotations

import dataclasses
import io
from typing import Optional, Tuple

import numpy as np
import torch

from ..assets.smpl_assets import _SmplUnpickler, _to_array
from ..precision import no_tf32
from .smpl import SmplParams, smpl_forward

MANO_VERTEX_NUM = 778
MANO_JOINT_NUM = 16
# kintree parents for the 16 MANO joints (root + 3 per finger)
MANO_PARENTS = (0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
# fingertip vertices (right hand): thumb, index, middle, ring, pinky
FINGERTIP_VERTEX = (745, 317, 445, 556, 673)
# reorder [16 joints + 5 tips] -> Wrist, Thumb1..4, Index1..4, ...
# (reference: lib/_mano.py:29)
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12,
                 19, 7, 8, 9, 20)

MANO_JOINTS_NAME = (
    "Wrist", "Thumb_1", "Thumb_2", "Thumb_3", "Thumb_4", "Index_1",
    "Index_2", "Index_3", "Index_4", "Middle_1", "Middle_2", "Middle_3",
    "Middle_4", "Ring_1", "Ring_2", "Ring_3", "Ring_4", "Pinky_1",
    "Pinky_2", "Pinky_3", "Pinky_4")
MANO_SKELETON = ((0, 1), (0, 5), (0, 9), (0, 13), (0, 17), (1, 2), (2, 3),
                 (3, 4), (5, 6), (6, 7), (7, 8), (9, 10), (10, 11),
                 (11, 12), (13, 14), (14, 15), (15, 16), (17, 18),
                 (18, 19), (19, 20))


@dataclasses.dataclass(frozen=True)
class ManoModel:
    """Plain-numpy MANO parameters (`load_mano_pkl`, or `synthetic_mano`
    for tests)."""

    v_template: np.ndarray        # [778, 3]
    shapedirs: np.ndarray         # [778, 3, 10]
    posedirs: np.ndarray          # [778, 3, 135]
    j_regressor: np.ndarray       # [16, 778]
    weights: np.ndarray           # [778, 16]
    faces: np.ndarray             # [F, 3]
    hands_components: np.ndarray  # [45, 45] PCA basis
    hands_mean: np.ndarray        # [45]
    parents: tuple = MANO_PARENTS

    def extended_regressor(self) -> np.ndarray:
        """[21, 778] regressor with fingertips, reordered
        (reference: lib/_mano.py:22-29)."""
        tips = np.zeros((5, self.v_template.shape[0]), np.float32)
        for i, vid in enumerate(FINGERTIP_VERTEX):
            tips[i, vid % self.v_template.shape[0]] = 1.0
        reg = np.concatenate([self.j_regressor.astype(np.float32), tips])
        return reg[list(JOINT_REORDER)]


class ManoParams(SmplParams):
    """The MANO tables as f32 tensors on one device: SMPL's tables with the
    hand's tree, plus the PCA components kept (`selected_comps`
    [ncomps, 45]) and the mean hand pose (`hands_mean` [45])."""

    def __init__(self, *tables, selected_comps: torch.Tensor,
                 hands_mean: torch.Tensor, parents=MANO_PARENTS):
        super().__init__(*tables, parents)
        self.selected_comps = selected_comps
        self.hands_mean = hands_mean

    @classmethod
    def from_model(cls, model: ManoModel, ncomps: int = 45,
                   use_pca: bool = True, flat_hand_mean: bool = False,
                   device="cuda") -> "ManoParams":
        comps = (model.hands_components[:ncomps] if use_pca
                 else np.eye(45, dtype=np.float32))
        mean = (np.zeros(45, np.float32) if flat_hand_mean
                else model.hands_mean)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)

        return cls(t(model.v_template), t(model.shapedirs),
                   t(model.posedirs), t(model.j_regressor), t(model.weights),
                   selected_comps=t(comps), hands_mean=t(mean),
                   parents=tuple(model.parents))


def mano_forward(params: ManoParams, pose_coeffs: torch.Tensor,
                 betas: torch.Tensor, trans: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pose [B, 3+ncomps], betas [B, 10][, trans [B, 3]]) ->
    (verts [B, 778, 3], joints [B, 16, 3]) in metres. The full hand pose is
    hands_mean + coeffs @ selected_comps behind the root's 3 entries
    (reference: manolayer.py:109-155). True f32 (TF32 off)."""
    no_tf32()
    hand_pose = params.hands_mean + pose_coeffs[:, 3:] @ params.selected_comps
    full_pose = torch.cat([pose_coeffs[:, :3], hand_pose], dim=1)  # [B, 48]
    return smpl_forward(params, full_pose, betas, trans)


def synthetic_mano(seed: int = 0) -> ManoModel:
    """Deterministic MANO-like model for tests (not the licensed hand); the
    JAX package's draws in its order, so both packages build the same
    model from one seed."""
    rng = np.random.default_rng(seed)
    # rest joints: wrist at origin, 5 fingers x 3 joints
    joints = [np.zeros(3, np.float32)]
    for f in range(5):
        base = np.array([0.02 + 0.018 * f, 0.09, 0.0], np.float32)
        d = np.array([0.005 * (f - 2), 0.028, 0.0], np.float32)
        for k in range(3):
            joints.append(base + (k + 1) * d)
    joints = np.stack(joints)
    parents = np.asarray(MANO_PARENTS)
    bone = rng.integers(1, MANO_JOINT_NUM, MANO_VERTEX_NUM)
    t = rng.uniform(0, 1, (MANO_VERTEX_NUM, 1)).astype(np.float32)
    v = (joints[parents[bone]] + t * (joints[bone] - joints[parents[bone]])
         + rng.normal(0, 0.008, (MANO_VERTEX_NUM, 3))).astype(np.float32)
    d2 = ((v[:, None] - joints[None]) ** 2).sum(-1)
    w = 1.0 / (d2 + 1e-4)
    thr = np.sort(w, 1)[:, -4][:, None]
    w = np.where(w >= thr, w, 0)
    weights = (w / w.sum(1, keepdims=True)).astype(np.float32)
    jr = 1.0 / (d2.T + 1e-4)
    thr = np.sort(jr, 1)[:, -8][:, None]
    jr = np.where(jr >= thr, jr, 0)
    j_regressor = (jr / jr.sum(1, keepdims=True)).astype(np.float32)
    faces = rng.integers(0, MANO_VERTEX_NUM, (1538, 3)).astype(np.int32)
    faces[:, 1] = (faces[:, 0] + 1) % MANO_VERTEX_NUM
    faces[:, 2] = (faces[:, 0] + 2) % MANO_VERTEX_NUM
    comps = np.linalg.qr(rng.normal(size=(45, 45)))[0].astype(np.float32)
    return ManoModel(
        v_template=v,
        shapedirs=rng.normal(0, .005, (MANO_VERTEX_NUM, 3, 10)).astype(
            np.float32),
        posedirs=rng.normal(0, .0005, (MANO_VERTEX_NUM, 3, 135)).astype(
            np.float32),
        j_regressor=j_regressor,
        weights=weights,
        faces=faces,
        hands_components=comps,
        hands_mean=rng.normal(0, 0.1, 45).astype(np.float32),
    )


def load_mano_pkl(path: str) -> ManoModel:
    """Decode a MANO_RIGHT/LEFT.pkl into a ManoModel (chumpy-free, the SMPL
    loader's unpickler)."""
    with open(path, "rb") as f:
        raw = _SmplUnpickler(io.BytesIO(f.read()),
                             encoding="latin1").load()
    data = {k: _to_array(v) for k, v in raw.items()}
    parents = tuple(int(p) for p in np.asarray(data["kintree_table"])[0])
    parents = (0,) + parents[1:]
    return ManoModel(
        v_template=np.asarray(data["v_template"], np.float32),
        shapedirs=np.asarray(data["shapedirs"], np.float32)[..., :10],
        posedirs=np.asarray(data["posedirs"], np.float32),
        j_regressor=np.asarray(data["J_regressor"], np.float32),
        weights=np.asarray(data["weights"], np.float32),
        faces=np.asarray(data["f"], np.int32),
        hands_components=np.asarray(data["hands_components"], np.float32),
        hands_mean=np.asarray(data["hands_mean"], np.float32),
        parents=parents,
    )
