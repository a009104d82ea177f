"""Evaluation metrics on batched tensors (counterpart of
gator_tpu/metrics.py). PA-MPJPE runs as one batched SVD on the device (the
reference aligns per sample in numpy: lib/coord_utils.py:127-149).
Errors are millimetres when the inputs are millimetres.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .precision import no_tf32


def root_align(x: torch.Tensor, root_idx: int = 0) -> torch.Tensor:
    """Subtract the root joint/vertex row: [B, N, 3] -> [B, N, 3]."""
    return x - x[:, root_idx:root_idx + 1]


def _subset(x: torch.Tensor, eval_joints):
    if eval_joints is None:
        return x
    return x[:, torch.as_tensor(list(eval_joints), device=x.device)]


def mpjpe(pred, gt, eval_joints: Optional[Sequence[int]] = None,
          root_idx: int = 0, align: bool = True,
          per_sample: bool = False):
    """Mean per-joint position error, root-aligned, over a joint subset
    (reference: Human36M/dataset.py:455-478); per_sample=True returns the
    [B] per-sample means so a caller can aggregate exactly over ragged
    batches (reference: lib/core/base.py:224-230)."""
    if align:
        pred = root_align(pred, root_idx)
        gt = root_align(gt, root_idx)
    pred, gt = _subset(pred, eval_joints), _subset(gt, eval_joints)
    err = torch.sqrt(((pred - gt) ** 2).sum(-1)).mean(-1)
    return err if per_sample else err.mean()


def _mat3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, k] written out elementwise (exact f32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def procrustes_align(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Batched similarity Procrustes, pred -> gt (reference:
    lib/coord_utils.py:127-149): H = (A-cA)^T (B-cB) / n, R = V U^T with the
    last singular pair flipped when det(R) < 0, c = sum(s) / var(A),
    t = cB - c R cA. R does not depend on the signs the SVD picks for its
    singular vectors. pred, gt: [B, N, 3] -> aligned pred [B, N, 3]."""
    no_tf32()
    n = pred.shape[1]
    mu_a = pred.mean(dim=1, keepdim=True)
    mu_b = gt.mean(dim=1, keepdim=True)
    a0 = pred - mu_a
    b0 = gt - mu_b
    h = torch.einsum("bni,bnj->bij", a0, b0) / n
    u, s, vh = torch.linalg.svd(h)
    v = vh.transpose(-1, -2)
    det = torch.linalg.det(_mat3(v, u.transpose(-1, -2)))
    sign = torch.where(det < 0, -1.0, 1.0).to(pred.dtype)
    s = torch.cat([s[:, :-1], s[:, -1:] * sign[:, None]], dim=1)
    v = torch.cat([v[..., :-1], v[..., -1:] * sign[:, None, None]], dim=-1)
    rot = _mat3(v, u.transpose(-1, -2))                    # V U^T
    var_a = a0.var(dim=1, unbiased=False).sum(dim=-1)
    scale = (s.sum(dim=-1) / var_a)[:, None, None]
    aligned = scale * _mat3(rot, pred.transpose(1, 2)).transpose(1, 2)
    t = mu_b - scale * _mat3(rot, mu_a.transpose(1, 2)).transpose(1, 2)
    return aligned + t


def pa_mpjpe(pred, gt, eval_joints: Optional[Sequence[int]] = None,
             root_idx: int = 0, align: bool = True):
    """Procrustes-aligned MPJPE, after root alignment and the joint subset
    (reference: Human36M/dataset.py:496-504)."""
    if align:
        pred = root_align(pred, root_idx)
        gt = root_align(gt, root_idx)
    pred, gt = _subset(pred, eval_joints), _subset(gt, eval_joints)
    aligned = procrustes_align(pred, gt)
    return torch.sqrt(((aligned - gt) ** 2).sum(-1)).mean()


def mpvpe(pred_mesh, gt_mesh, pred_root, gt_root, per_sample: bool = False):
    """Mesh vertex error after root-joint alignment; roots are [B, 1, 3]
    (reference: compute_both_err, Human36M/dataset.py:466-478)."""
    err = torch.sqrt((((pred_mesh - pred_root) - (gt_mesh - gt_root)) ** 2)
                     .sum(-1)).mean(-1)
    return err if per_sample else err.mean()


def compute_errors(gt3ds, preds):
    """Per-sample (MPJPE, PA-MPJPE) over LSP-14-style joints after pelvis
    (hip-midpoint) alignment (reference: lib/eval_utils.py:311-334).
    gt3ds/preds: [B, 14, 3] -> (errors [B], pa_errors [B])."""
    def align(x):
        return x - (x[:, 2:3] + x[:, 3:4]) / 2.0

    gt = align(gt3ds)
    pred = align(preds)
    errors = torch.sqrt(((gt - pred) ** 2).sum(-1)).mean(-1)
    aligned = procrustes_align(pred, gt)
    pa_errors = torch.sqrt(((gt - aligned) ** 2).sum(-1)).mean(-1)
    return errors, pa_errors


def accel_error(joints_gt, joints_pred):
    """Acceleration error over an [N, J, 3] sequence
    (reference: lib/coord_utils.py:194-222)."""
    accel_gt = joints_gt[:-2] - 2 * joints_gt[1:-1] + joints_gt[2:]
    accel_pred = joints_pred[:-2] - 2 * joints_pred[1:-1] + joints_pred[2:]
    return torch.linalg.vector_norm(accel_pred - accel_gt, dim=2).mean(dim=1)
