"""Batched SMPL layer on tensors (counterpart of gator_tpu/bodymodel/smpl.py;
reference: smplpytorch/smplpytorch/pytorch/smpl_layer.py:65-158).

One batched program per call: axis-angle -> rotation matrices for all 24
joints, shape and pose blendshapes as two products, the kinematic chain
level by level over the joint tree (every joint of a level composes against
its parent on the level above in one batched product), and linear blend
skinning as one [V, 24] x [B, 24, 12] product. Plain torch: the JAX
function has no Pallas kernel. It runs in true f32 (TF32 off), as the JAX
code pins Precision.HIGHEST (smpl.py:73).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..assets.smpl_assets import SmplModel
from ..precision import no_tf32
from .rotations import axis_angle_to_rotmat, rotmat_flat_minus_id


def _tree_levels(parents) -> List[np.ndarray]:
    """Joint ids grouped by depth in the tree (the root is level 0)."""
    depth = [0] * len(parents)
    for i in range(1, len(parents)):
        depth[i] = depth[parents[i]] + 1
    return [np.asarray([i for i in range(len(parents)) if depth[i] == d])
            for d in range(max(depth) + 1)]


class SmplParams:
    """The SMPL constants as tensors on one device, and the joint tree's
    level structure (index tensors on the same device)."""

    def __init__(self, v_template: torch.Tensor, shapedirs: torch.Tensor,
                 posedirs: torch.Tensor, j_regressor: torch.Tensor,
                 weights: torch.Tensor, parents: Tuple[int, ...]):
        self.v_template = v_template      # [V, 3]
        self.shapedirs = shapedirs        # [V, 3, 10]
        self.posedirs = posedirs          # [V, 3, 207]
        self.j_regressor = j_regressor    # [24, V]
        self.weights = weights            # [V, 24]
        self.parents = tuple(int(p) for p in parents)
        dev = v_template.device
        levels = _tree_levels(self.parents)
        # per level after the root: (joint ids, each parent's position in
        # the level above); `inv` puts the concatenated levels in joint order
        self.chain = []
        pos = {int(j): k for k, j in enumerate(levels[0])}
        for ids in levels[1:]:
            ppos = [pos[self.parents[int(i)]] for i in ids]
            par = [self.parents[int(i)] for i in ids]
            self.chain.append(tuple(torch.as_tensor(a, device=dev)
                                    for a in (ids, ppos, par)))
            pos = {int(j): k for k, j in enumerate(ids)}
        self.root_ids = torch.as_tensor(levels[0], device=dev)
        self.inv = torch.as_tensor(np.argsort(np.concatenate(levels)),
                                   device=dev)

    @classmethod
    def from_model(cls, model: SmplModel, device="cuda") -> "SmplParams":
        """f32 tables of `model` on `device`."""
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)

        return cls(t(model.v_template), t(model.shapedirs),
                   t(model.posedirs), t(model.j_regressor), t(model.weights),
                   model.kintree_parents)


def smpl_forward(params: SmplParams, pose_axisang: torch.Tensor,
                 betas: torch.Tensor, trans: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pose [B, 72], betas [B, 10][, trans [B, 3]]) -> (verts [B, V, 3],
    joints [B, 24, 3]) in metres: root-rotation-first kinematics,
    rest-joint translation subtracted, homogeneous LBS."""
    b = pose_axisang.shape[0]
    nj = len(params.parents)
    rotmats = axis_angle_to_rotmat(pose_axisang.reshape(b, nj, 3))
    return smpl_forward_rotmat(params, rotmats, betas, trans)


def smpl_forward_rotmat(params: SmplParams, rotmats: torch.Tensor,
                        betas: torch.Tensor,
                        trans: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`smpl_forward` from rotation matrices (rotmats [B, 24, 3, 3], the
    root's first; smplx's `pose2rot=False`, as MotionBERT's mesh head
    calls it) -> (verts [B, V, 3], joints [B, 24, 3]) in metres."""
    no_tf32()
    b = rotmats.shape[0]
    nj = len(params.parents)
    pose_feature = rotmat_flat_minus_id(rotmats[:, 1:])     # [B, 207]

    v_shaped = params.v_template + torch.einsum(
        "vcs,bs->bvc", params.shapedirs, betas)
    joints_rest = torch.einsum("jv,bvc->bjc", params.j_regressor, v_shaped)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", params.posedirs,
                                      pose_feature)

    # kinematic chain, one level of the tree at a time; the 3x3 products
    # are written out elementwise (exact f32 whatever the matmul settings)
    rot_lv = [rotmats[:, params.root_ids]]
    loc_lv = [joints_rest[:, params.root_ids]]
    for ids, ppos, par in params.chain:
        prev_r = rot_lv[-1][:, ppos]                         # [B, n, 3, 3]
        prev_l = loc_lv[-1][:, ppos]
        off = joints_rest[:, ids] - joints_rest[:, par]
        rot_lv.append((prev_r[..., :, :, None]
                       * rotmats[:, ids][..., None, :, :]).sum(-2))
        loc_lv.append(prev_l + (prev_r * off[..., None, :]).sum(-1))
    rot_global = torch.cat(rot_lv, dim=1)[:, params.inv]    # [B, 24, 3, 3]
    joints = torch.cat(loc_lv, dim=1)[:, params.inv]        # [B, 24, 3]

    # relative-to-rest transforms: t_rel = t_global - R_global @ j_rest
    t_rel = joints - (rot_global * joints_rest[..., None, :]).sum(-1)
    a_rel = torch.cat([rot_global, t_rel[..., None]], dim=-1)   # [B,24,3,4]

    # LBS: [V, 24] x [B, 24, 12], then each vertex's 3x4 transform
    t_vert = torch.einsum("vj,bjk->bvk", params.weights,
                          a_rel.reshape(b, nj, 12)).reshape(b, -1, 3, 4)
    verts = (t_vert[..., :3] * v_posed[..., None, :]).sum(-1) + t_vert[..., 3]

    if trans is not None:
        verts = verts + trans[:, None, :]
        joints = joints + trans[:, None, :]
    return verts, joints


def substitute_mean_betas(betas: np.ndarray,
                          mean_betas: np.ndarray) -> np.ndarray:
    """An all-zero beta row means 'use the model's mean betas'
    (reference: smpl_layer.py:87-95)."""
    zero = np.all(betas == 0, axis=-1, keepdims=True)
    return np.where(zero, mean_betas[None], betas)
