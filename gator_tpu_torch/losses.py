"""Training losses (counterpart of gator_tpu/losses.py; reference:
lib/core/loss.py).

The face-based mesh losses gather each face's three corners with a plain
index gather; autograd's scatter-add is its backward (the JAX package needs
a custom VJP there only because XLA's scatter serialises on the TPU).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


def _l2_normalize(x: torch.Tensor, dim: int = -1,
                  eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), the clamp inside the sqrt so that a zero-length
    (bf16-rounded) edge gives a finite gradient (gator_tpu/losses.py:76)."""
    return x / torch.sqrt(torch.clamp((x * x).sum(dim, keepdim=True),
                                      min=eps * eps))


def coord_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Validity-masked L1, mean over all elements (reference: loss.py:10-23
    masks both operands and keeps reduction='mean')."""
    if valid is not None:
        pred = pred * valid
        target = target * valid
    return (pred - target).abs().mean()


def _corners(mesh: torch.Tensor, faces: torch.Tensor):
    return mesh[:, faces[:, 0]], mesh[:, faces[:, 1]], mesh[:, faces[:, 2]]


def _faces(faces, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(faces, np.int64), device=device)


def _normal_from_corners(po, pg) -> torch.Tensor:
    """Cosine between predicted edges and GT face normals
    (reference: loss.py:61-87); the mean is taken in f32."""
    p0, p1, p2 = po
    g0, g1, g2 = pg
    v1 = _l2_normalize(p1 - p0)
    v2 = _l2_normalize(p2 - p0)
    v3 = _l2_normalize(p2 - p1)
    normal = _l2_normalize(torch.cross(_l2_normalize(g1 - g0),
                                       _l2_normalize(g2 - g0), dim=-1))
    cos = [(v * normal).sum(-1).abs() for v in (v1, v2, v3)]
    return torch.cat(cos, dim=1).float().mean()


def _edge_from_corners(po, pg) -> torch.Tensor:
    """|edge length difference| over the three face edges
    (reference: loss.py:90-113)."""
    def elen(a, b):
        return torch.sqrt(torch.clamp(((a - b) ** 2).sum(-1), min=1e-24))

    p0, p1, p2 = po
    g0, g1, g2 = pg
    d = [(elen(p0, p1) - elen(g0, g1)).abs(),
         (elen(p0, p2) - elen(g0, g2)).abs(),
         (elen(p1, p2) - elen(g1, g2)).abs()]
    return torch.cat(d, dim=1).float().mean()


def normal_vector_loss(coord_out: torch.Tensor, coord_gt: torch.Tensor,
                       faces) -> torch.Tensor:
    f = _faces(faces, coord_out.device)
    return _normal_from_corners(_corners(coord_out, f), _corners(coord_gt, f))


def edge_length_loss(coord_out: torch.Tensor, coord_gt: torch.Tensor,
                     faces) -> torch.Tensor:
    f = _faces(faces, coord_out.device)
    return _edge_from_corners(_corners(coord_out, f), _corners(coord_gt, f))


def build_laplacian(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """Uniform graph Laplacian, row-normalised by degree (defined but
    unused in the reference; reference: loss.py:26-47)."""
    lap = np.zeros((num_verts, num_verts), np.float32)
    for a, b in ((0, 1), (1, 0), (1, 2), (2, 1), (2, 0), (0, 2)):
        lap[faces[:, a], faces[:, b]] = -1
    np.fill_diagonal(lap, -lap.sum(1))
    lap /= (np.diag(lap)[:, None] + 1e-8)
    return lap


def laplacian_loss(coord_out: torch.Tensor, laplacian,
                   average: bool = False) -> torch.Tensor:
    lap = torch.as_tensor(np.asarray(laplacian), dtype=coord_out.dtype,
                          device=coord_out.device)
    x = (torch.einsum("vw,bwc->bvc", lap, coord_out) ** 2).sum(-1)
    if average:
        return x.sum() / coord_out.shape[0]
    return x.mean()


class LossWeights(NamedTuple):
    """Loss weighting (reference: lib/core/config.py:58-60; assembly
    lib/core/base.py:139-148)."""

    normal: float = 0.1
    edge: float = 20.0
    joint: float = 1e-3


class GatorLossOut(NamedTuple):
    total: torch.Tensor
    vertex: torch.Tensor
    normal: torch.Tensor
    edge: torch.Tensor
    reg_joint: torch.Tensor
    lift_joint: torch.Tensor


def gator_loss(pred_mesh, pred_reg_pose, pred_lift_pose,
               gt_mesh, gt_reg_pose, gt_lift_pose,
               mesh_valid, reg_valid, lift_valid,
               faces, weights: LossWeights, edge_enabled,
               face_loss_dtype: Optional[torch.dtype] = None) -> GatorLossOut:
    """Stage-2 loss: vertex L1 + normal + (gated) edge + two joint L1s
    (reference: lib/core/base.py:139-148). `face_loss_dtype` (bf16 on the
    fast training path) is the compute dtype of the two face terms; their
    reductions, the L1 terms and the returned scalars are f32."""
    f = _faces(faces, pred_mesh.device)
    fm_pred, fm_gt = pred_mesh, gt_mesh
    if face_loss_dtype is not None:
        fm_pred = pred_mesh.to(face_loss_dtype)
        fm_gt = gt_mesh.to(face_loss_dtype)
    l_vert = coord_l1_loss(pred_mesh, gt_mesh, mesh_valid)
    po, pg = _corners(fm_pred, f), _corners(fm_gt, f)
    l_norm = weights.normal * _normal_from_corners(po, pg)
    l_edge = weights.edge * edge_enabled * _edge_from_corners(po, pg)
    l_reg = weights.joint * coord_l1_loss(pred_reg_pose, gt_reg_pose,
                                          reg_valid)
    l_lift = weights.joint * coord_l1_loss(pred_lift_pose, gt_lift_pose,
                                           lift_valid)
    total = l_vert + l_norm + l_edge + l_reg + l_lift
    return GatorLossOut(total, l_vert, l_norm, l_edge, l_reg, l_lift)
