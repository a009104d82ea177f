"""2D/3D keypoint augmentation (host numpy, explicit generator; counterpart
of gator_tpu/data/augment.py, reference: lib/aug_utils.py). The reference
builds its affine with cv2.getAffineTransform from three point pairs; here
the same three correspondences go through an explicit linear solve, so cv2
is not needed. The draws are the JAX package's, in its order, so one
generator gives both packages the same numbers."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .coords import get_center_scale


def transform_joint_to_other_db(src_joint, src_name, dst_name):
    """Reindex joints between joint-set name tuples
    (reference: aug_utils.py:10-21)."""
    new_joint = np.zeros((len(dst_name),) + src_joint.shape[1:],
                         dtype=np.float32)
    for src_idx, name in enumerate(src_name):
        if name in dst_name:
            new_joint[dst_name.index(name)] = src_joint[src_idx]
    return new_joint


def _rotate_2d(pt, rad):
    cs, sn = np.cos(rad), np.sin(rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs])


def _third_point(a, b):
    d = a - b
    return b + np.array([-d[1], d[0]])


def get_affine_transform(center, scale, rot_deg, output_size,
                         inv: bool = False) -> np.ndarray:
    """2x3 affine mapping the (center, scale) crop onto output_size (w, h),
    rotated by rot_deg: the centre, the rotated top-edge midpoint and a
    perpendicular third point (reference: aug_utils.py:140-173; only
    scale[0], the crop width, sets the isotropic zoom)."""
    center = np.asarray(center, np.float64)
    src_w = float(scale[0])
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    rad = np.pi * rot_deg / 180.0
    src_dir = _rotate_2d(np.array([0.0, src_w * -0.5]), rad)
    dst_dir = np.array([0.0, dst_w * -0.5])

    src = np.zeros((3, 2))
    dst = np.zeros((3, 2))
    src[0] = center
    src[1] = center + src_dir
    src[2] = _third_point(src[0], src[1])
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = _third_point(dst[0], dst[1])

    if inv:
        src, dst = dst, src
    a_mat = np.concatenate([src, np.ones((3, 1))], axis=1)   # [3, 3]
    trans = np.linalg.solve(a_mat, dst).T                    # [2, 3]
    return trans.astype(np.float32)


def affine_transform(pt, trans) -> np.ndarray:
    """(reference: aug_utils.py:176-179)."""
    return (trans @ np.array([pt[0], pt[1], 1.0]))[:2]


def affine_transform_batch(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """[N, 2] points through a 2x3 affine."""
    return pts @ trans[:, :2].T + trans[:, 2]


def flip_2d_joint(kp, width, flip_pairs):
    """(reference: aug_utils.py:33-39)."""
    kp = kp.copy()
    kp[:, 0] = width - kp[:, 0] - 1
    for a, b in flip_pairs:
        kp[[a, b]] = kp[[b, a]]
    return kp


def flip_3d_joint(kp, flip_pairs):
    """(reference: aug_utils.py:42-48)."""
    kp = kp.copy()
    for a, b in flip_pairs:
        kp[[a, b]] = kp[[b, a]]
    kp[:, 0] = -kp[:, 0]
    return kp


def j2d_processing(kp, res, bbox, rot, flip: bool,
                   flip_pairs) -> Tuple[np.ndarray, np.ndarray]:
    """Crop/rotate 2D joints into model input space; res = (w, h)
    (reference: aug_utils.py:51-64)."""
    center, scale = get_center_scale(bbox)
    trans = get_affine_transform(center, scale, rot, res)
    kp = kp.copy().astype(np.float32)
    kp[:, :2] = affine_transform_batch(kp[:, :2], trans)
    if flip:
        kp = flip_2d_joint(kp, res[0], flip_pairs)
    return kp.astype(np.float32), trans


def j3d_processing(s, rot, flip: bool, flip_pairs) -> np.ndarray:
    """In-plane rotation and optional flip of 3D joints
    (reference: aug_utils.py:67-83)."""
    rot_mat = np.eye(3, dtype=np.float32)
    if rot != 0:
        rad = -rot * np.pi / 180.0
        sn, cs = np.sin(rad), np.cos(rad)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
    s = s @ rot_mat.T
    if flip:
        s = flip_3d_joint(s, flip_pairs)
    return s.astype(np.float32)


def augm_params(is_train: bool, flip_enabled: bool, rotate_factor: float,
                rng: np.random.Generator) -> Tuple[int, float]:
    """(flip, rot) of one sample: flip w.p. 0.5 when enabled; rot ~
    clip(N(0, 1) * rf, +-2 rf), zeroed half the time (reference:
    aug_utils.py:98-117)."""
    if not is_train:
        return 0, 0.0
    flip = int(flip_enabled and rng.uniform() <= 0.5)
    rot = float(np.clip(rng.standard_normal() * rotate_factor,
                        -2 * rotate_factor, 2 * rotate_factor))
    if rng.uniform() <= 0.5:
        rot = 0.0
    return flip, rot


def augm_params_batch(is_train: bool, flip_enabled: bool,
                      rotate_factor: float, b: int,
                      rng: np.random.Generator
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(flips [B] int64, rots [B] f32): `augm_params`'s distribution in
    three vectorised draws. Evaluation draws nothing."""
    if not is_train:
        return np.zeros(b, np.int64), np.zeros(b, np.float32)
    flips = ((rng.uniform(size=b) <= 0.5) & flip_enabled).astype(np.int64)
    rots = np.clip(rng.standard_normal(b) * rotate_factor,
                   -2 * rotate_factor, 2 * rotate_factor)
    rots[rng.uniform(size=b) <= 0.5] = 0.0
    return flips, rots.astype(np.float32)


def normalize_input_pose(joint_img: np.ndarray,
                         input_shape: Sequence[int]) -> np.ndarray:
    """Final input normalisation: pixel coords to [0, 1] by the input
    (w, h), then standardised per sample
    (reference: Human36M/dataset.py:384-389)."""
    out = joint_img[:, :2] / np.array(
        [[input_shape[1], input_shape[0]]], dtype=np.float32)
    mean = out.mean(axis=0)
    std = out.std(axis=0)
    return ((out - mean) / std).astype(np.float32)
