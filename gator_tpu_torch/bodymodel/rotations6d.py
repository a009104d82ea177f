"""6D rotation representation and the SVD rotation projection on tensors
(counterpart of gator_tpu/bodymodel/rotations6d.py; reference:
manopth/manopth/rot6d.py:4-24, rotproj.py:4-21), and the SPIN/VIBE 6D
layout that MotionBERT's mesh head reads (`rot6d_to_rotmat_spin`)."""
from __future__ import annotations

import torch

from ..precision import no_tf32


def rot6d_to_rotmat(x6d: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] by Gram-Schmidt on the two column vectors
    (Zhou et al.'s continuous representation; manopth's
    compute_rotation_matrix_from_ortho6d)."""
    a1, a2 = x6d[..., 0:3], x6d[..., 3:6]
    b1 = a1 / torch.linalg.vector_norm(
        a1, dim=-1, keepdim=True).clamp(min=1e-8)
    proj = (b1 * a2).sum(-1, keepdim=True)
    b2 = a2 - proj * b1
    b2 = b2 / torch.linalg.vector_norm(
        b2, dim=-1, keepdim=True).clamp(min=1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rot6d_to_rotmat_spin(x6d: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] in the SPIN/VIBE layout that MotionBERT's
    mesh head uses (MotionBERT lib/utils/utils_smpl.py `rot6d_to_rotmat`):
    the six numbers are a [3, 2] matrix in row order, a1 = x[0::2] and
    a2 = x[1::2], not manopth's [a1 | a2]; normalised as F.normalize does
    (eps 1e-12), then Gram-Schmidt."""
    a1, a2 = x6d[..., 0::2], x6d[..., 1::2]
    b1 = a1 / torch.linalg.vector_norm(
        a1, dim=-1, keepdim=True).clamp(min=1e-12)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.vector_norm(
        b2, dim=-1, keepdim=True).clamp(min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(rot: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6] (the first two columns)."""
    return torch.cat([rot[..., :, 0], rot[..., :, 1]], dim=-1)


def project_to_rotation(mat: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix, U diag(1, 1, det(U Vᵀ)) Vᵀ from the SVD,
    batched (reference: manopth/manopth/rotproj.py:4-21). The factors'
    signs are the SVD routine's, the product is not: it is unique for a
    non-degenerate input. True f32 (TF32 off)."""
    no_tf32()
    u, _, vh = torch.linalg.svd(mat)
    det = torch.linalg.det(u @ vh)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return (u * d[..., None, :]) @ vh
