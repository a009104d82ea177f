"""Rotation utilities on tensors (counterpart of
gator_tpu/bodymodel/rotations.py): batched axis-angle -> rotation matrix via
quaternions, with the reference's `norm(v + 1e-8)` regulariser
(reference: smplpytorch/smplpytorch/pytorch/rodrigues_layer.py:13-52), and
the branch-complete rotation matrix -> quaternion / axis-angle.
"""
from __future__ import annotations

import torch


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) quaternions -> [..., 3, 3] rotation matrices."""
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return rot.reshape(rot.shape[:-1] + (3, 3))


def axis_angle_to_rotmat(axisang: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle vectors -> [..., 3, 3] rotation matrices, with
    the reference's +1e-8 pre-norm regulariser (zero rotations included)."""
    angle = torch.linalg.vector_norm(axisang + 1e-8, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    return quat_to_rotmat(quat)


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w, x, y, z), Shepperd's extraction: the
    largest of {trace, r00, r11, r22} picks the branch, so rotations near
    pi (trace -> -1) stay exact; canonicalised to w >= 0."""
    r00, r11, r22 = rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]
    r01, r02 = rot[..., 0, 1], rot[..., 0, 2]
    r10, r12 = rot[..., 1, 0], rot[..., 1, 2]
    r20, r21 = rot[..., 2, 0], rot[..., 2, 1]
    t = r00 + r11 + r22

    def clamped_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    s0 = 2.0 * clamped_sqrt(1.0 + t)                      # = 4w
    q0 = torch.stack([0.25 * s0, (r21 - r12) / s0,
                      (r02 - r20) / s0, (r10 - r01) / s0], dim=-1)
    s1 = 2.0 * clamped_sqrt(1.0 + r00 - r11 - r22)        # = 4x
    q1 = torch.stack([(r21 - r12) / s1, 0.25 * s1,
                      (r01 + r10) / s1, (r02 + r20) / s1], dim=-1)
    s2 = 2.0 * clamped_sqrt(1.0 - r00 + r11 - r22)        # = 4y
    q2 = torch.stack([(r02 - r20) / s2, (r01 + r10) / s2,
                      0.25 * s2, (r12 + r21) / s2], dim=-1)
    s3 = 2.0 * clamped_sqrt(1.0 - r00 - r11 + r22)        # = 4z
    q3 = torch.stack([(r10 - r01) / s3, (r02 + r20) / s3,
                      (r12 + r21) / s3, 0.25 * s3], dim=-1)

    diag_q = torch.where(((r00 > r11) & (r00 > r22))[..., None], q1,
                         torch.where((r11 > r22)[..., None], q2, q3))
    q = torch.where((t > 0.0)[..., None], q0, diag_q)
    q = torch.where(q[..., :1] < 0.0, -q, q)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def rotmat_to_axis_angle(rot: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrices -> [..., 3] axis-angle, angle in
    [0, pi]; re-encodes the camera-rotated SMPL root pose (the reference
    does it per sample with transforms3d, Human36M/dataset.py:268-274)."""
    q = rotmat_to_quat(rot)
    w, xyz = q[..., 0], q[..., 1:]
    norm = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm[..., 0], w)
    axis = xyz / torch.clamp(norm, min=1e-12)
    return axis * angle[..., None]


def rotmat_flat_minus_id(rotmats: torch.Tensor) -> torch.Tensor:
    """[..., J, 3, 3] -> [..., J*9] with the identity subtracted (the SMPL
    pose-blendshape feature; reference: tensutils.py:41-48)."""
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    return (rotmats - eye).reshape(rotmats.shape[:-3] + (-1,))
