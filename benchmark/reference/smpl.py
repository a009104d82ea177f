"""SMPL and the ground-truth geometry of the training targets, in plain
float32 PyTorch (reference: smplpytorch's SMPL layer and rodrigues layer,
Human36M/COCO/MuCo dataset.py of kasvii/GATOR).

The SMPL forward is written joint by joint down the kinematic tree, a
different order of the same arithmetic from the port's level-batched
form. It reads the body model's arrays (the counterpart of the SMPL
files), handed to it as numpy.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import graph


def quat_to_rotmat(quat):
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    rot = torch.stack([
        w * w + x * x - y * y - z * z, 2 * x * y - 2 * w * z,
        2 * w * y + 2 * x * z,
        2 * w * z + 2 * x * y, w * w - x * x + y * y - z * z,
        2 * y * z - 2 * w * x,
        2 * x * z - 2 * w * y, 2 * w * x + 2 * y * z,
        w * w - x * x - y * y + z * z], dim=-1)
    return rot.reshape(rot.shape[:-1] + (3, 3))


def axis_angle_to_rotmat(aa):
    """Rodrigues through a quaternion, with the layer's +1e-8 inside the
    norm (smplpytorch rodrigues_layer.py:13-52)."""
    angle = torch.linalg.vector_norm(aa + 1e-8, dim=-1, keepdim=True)
    axis = aa / angle
    quat = torch.cat([torch.cos(angle * 0.5),
                      torch.sin(angle * 0.5) * axis], dim=-1)
    return quat_to_rotmat(quat)


def rotmat_to_axis_angle(rot):
    """Through a quaternion by Shepperd's branches, angle in [0, pi]."""
    r = rot
    t = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]

    def sq(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    s0 = 2.0 * sq(1.0 + t)
    q0 = torch.stack([0.25 * s0, (r[..., 2, 1] - r[..., 1, 2]) / s0,
                      (r[..., 0, 2] - r[..., 2, 0]) / s0,
                      (r[..., 1, 0] - r[..., 0, 1]) / s0], -1)
    s1 = 2.0 * sq(1.0 + r[..., 0, 0] - r[..., 1, 1] - r[..., 2, 2])
    q1 = torch.stack([(r[..., 2, 1] - r[..., 1, 2]) / s1, 0.25 * s1,
                      (r[..., 0, 1] + r[..., 1, 0]) / s1,
                      (r[..., 0, 2] + r[..., 2, 0]) / s1], -1)
    s2 = 2.0 * sq(1.0 - r[..., 0, 0] + r[..., 1, 1] - r[..., 2, 2])
    q2 = torch.stack([(r[..., 0, 2] - r[..., 2, 0]) / s2,
                      (r[..., 0, 1] + r[..., 1, 0]) / s2, 0.25 * s2,
                      (r[..., 1, 2] + r[..., 2, 1]) / s2], -1)
    s3 = 2.0 * sq(1.0 - r[..., 0, 0] - r[..., 1, 1] + r[..., 2, 2])
    q3 = torch.stack([(r[..., 1, 0] - r[..., 0, 1]) / s3,
                      (r[..., 0, 2] + r[..., 2, 0]) / s3,
                      (r[..., 1, 2] + r[..., 2, 1]) / s3, 0.25 * s3], -1)
    r00, r11, r22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    diag = torch.where(((r00 > r11) & (r00 > r22))[..., None], q1,
                       torch.where((r11 > r22)[..., None], q2, q3))
    q = torch.where((t > 0.0)[..., None], q0, diag)
    q = torch.where(q[..., :1] < 0.0, -q, q)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    norm = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm[..., 0], q[..., 0])
    return q[..., 1:] / torch.clamp(norm, min=1e-12) * angle[..., None]


class Smpl:
    """One body model's arrays on a device."""

    def __init__(self, model, device):
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)
        self.v_template = t(model.v_template)
        self.shapedirs = t(model.shapedirs)
        self.posedirs = t(model.posedirs)
        self.j_regressor = t(model.j_regressor)
        self.weights = t(model.weights)
        self.parents = [int(p) for p in model.kintree_parents]
        self.mean_betas = t(model.mean_betas)

    def forward(self, pose, betas, trans=None):
        """(pose [B, 72], betas [B, 10][, trans]) -> (verts [B, V, 3],
        joints [B, 24, 3]) in metres."""
        b = pose.shape[0]
        rot = axis_angle_to_rotmat(pose.reshape(b, 24, 3))
        v_shaped = self.v_template + torch.einsum("vcs,bs->bvc",
                                                  self.shapedirs, betas)
        j_rest = torch.einsum("jv,bvc->bjc", self.j_regressor, v_shaped)
        eye = torch.eye(3, device=pose.device)
        feat = (rot[:, 1:] - eye).reshape(b, -1)
        v_posed = v_shaped + torch.einsum("vcp,bp->bvc", self.posedirs, feat)
        g_rot, g_loc = [rot[:, 0]], [j_rest[:, 0]]
        for i in range(1, 24):
            p = self.parents[i]
            g_rot.append(g_rot[p] @ rot[:, i])
            g_loc.append(g_loc[p] + (g_rot[p] @ (j_rest[:, i] - j_rest[:, p])
                                     [..., None])[..., 0])
        g_rot = torch.stack(g_rot, 1)                       # [B, 24, 3, 3]
        joints = torch.stack(g_loc, 1)                      # [B, 24, 3]
        t_rel = joints - (g_rot @ j_rest[..., None])[..., 0]
        a = torch.cat([g_rot, t_rel[..., None]], -1).reshape(b, 24, 12)
        tv = torch.einsum("vj,bjk->bvk", self.weights, a).reshape(b, -1, 3, 4)
        verts = (tv[..., :3] @ v_posed[..., None])[..., 0] + tv[..., 3]
        if trans is not None:
            verts = verts + trans[:, None]
            joints = joints + trans[:, None]
        return verts, joints


def prep_shape(shape, mean_b, clean=True):
    """Rows with any |beta| > 3 are fits that failed: zeroed; an all-zero
    row takes the model's mean betas."""
    if clean:
        shape = torch.where((shape.abs() > 3).any(1, keepdim=True),
                            torch.zeros_like(shape), shape)
    return torch.where((shape == 0).all(1, keepdim=True), mean_b[None],
                       shape)


def rotate_root(pose, cam_r):
    root = axis_angle_to_rotmat(pose[:, :3])
    return torch.cat([rotmat_to_axis_angle(cam_r @ root), pose[:, 3:]], 1)


def mesh_camera(smpl: Smpl, pose, shape, trans, cam_r, cam_t):
    """Human3.6M's camera-space mesh in mm (dataset.py:254-300): the root
    rotated by the camera, the translation compensated about the root."""
    verts, joints = smpl.forward(rotate_root(pose, cam_r),
                                 prep_shape(shape, smpl.mean_betas))
    root = joints[:, :1]
    tr = (cam_r @ trans[..., None])[..., 0] + cam_t / 1000.0
    tr = tr[:, None] - root + (cam_r[:, None] @ root[..., None])[..., 0]
    return (verts + tr) * 1000.0


def coco_camera_joints(j_coco, mesh_mm):
    """The 17 COCO joints regressed from the mesh, then pelvis (mean of
    the hips) and neck (mean of the shoulders)."""
    cam = torch.einsum("jv,bvc->bjc", j_coco, mesh_mm)
    pelvis = 0.5 * (cam[:, 11] + cam[:, 12])
    neck = 0.5 * (cam[:, 5] + cam[:, 6])
    return torch.cat([cam, pelvis[:, None], neck[:, None]], 1)


def project(cam, focal, princpt):
    return cam[..., :2] / cam[..., 2:3] * focal[:, None] + princpt[:, None]


def fitting_error_3d(j_h36m, gt_cam, mesh_mm):
    """Mean joint distance (mm) of the mesh's regressed joints against the
    GT joints, both translation-aligned by their means."""
    gt = gt_cam - gt_cam[:, :1]
    reg = torch.einsum("jv,bvc->bjc", j_h36m, mesh_mm)
    reg = reg - reg.mean(1, keepdim=True) + gt.mean(1, keepdim=True)
    return torch.sqrt(((gt - reg) ** 2).sum(-1)).mean(-1)


def tables_of(assets, joint_set: str, device) -> Dict:
    """What the training reference reads of the model's asset files, and
    the input joint set's flip pairs (graph.py)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
    js = graph.JOINT_SETS[joint_set]
    return {"smpl": Smpl(assets.smpl, device),
            "j_h36m": t(assets.j_regressor_h36m),
            "j_coco": t(assets.j_regressor_coco),
            "faces": torch.as_tensor(np.asarray(assets.faces, np.int64),
                                     device=device),
            "flip_pairs": tuple(js["flip_pairs"]), "joint_num": js["joint_num"]}
