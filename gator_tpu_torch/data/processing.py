"""Host-side input preprocessing for serving (numpy): the GT-input branch
of gator_tpu/data/processing.py:82 `batch_crop_and_normalize` with no
noise, no flip and no rotation, and `add_pelvis_neck_scores` (:240).
The noise, augmentation and training readers are not ported yet.
"""
from __future__ import annotations

import numpy as np

INPUT_SHAPE = (384, 288)    # (H, W) of the model-input crop


def batch_crop_and_normalize(joint_img: np.ndarray) -> np.ndarray:
    """[B, J, 2] pixel keypoints -> [B, J, 2] model input: tight bbox ->
    aspect-snapped crop -> scale to the input resolution -> [0, 1] ->
    per-sample standardisation (reference: Human36M/dataset.py:364-389,
    421-453)."""
    res_h, res_w = INPUT_SHAPE
    aspect = res_w / res_h

    x0 = joint_img[..., 0].min(axis=1)
    x1 = joint_img[..., 0].max(axis=1)
    y0 = joint_img[..., 1].min(axis=1)
    y1 = joint_img[..., 1].max(axis=1)
    w = x1 - x0
    h = y1 - y0
    cx, cy = x0 + (w - 1) / 2.0, y0 + (h - 1) / 2.0
    # degenerate tight boxes (all joints coincident on an axis) take the
    # fallback crop: center (0.5, 0.5), unit source width
    bad = (w < 1.0) | (h < 1.0)
    w = w - 1.0
    h = h - 1.0
    h = np.where(w > aspect * h, w / aspect, h)
    w = np.where(w < aspect * h, h * aspect, w)
    w = np.where(bad, 1.0, w)
    cx = np.where(bad, 0.5, cx)
    cy = np.where(bad, 0.5, cy)

    k = res_w / w
    rel = joint_img - np.stack([cx, cy], axis=1)[:, None, :]
    out = np.stack([rel[..., 0] * k[:, None] + res_w / 2.0,
                    rel[..., 1] * k[:, None] + res_h / 2.0], axis=-1)
    out = out / np.array([[res_w, res_h]], np.float32)
    mean = out.mean(axis=1, keepdims=True)
    std = out.std(axis=1, keepdims=True)
    return ((out - mean) / std).astype(np.float32)


def add_pelvis_neck_scores(joints: np.ndarray, names) -> np.ndarray:
    """[N, 17, 3] (x, y, score) -> [N, 19, 3] with synthesized pelvis and
    neck; the synthesized score is the product of the parents'
    (reference: demo/run.py:103-121)."""
    lhip, rhip = names.index("L_Hip"), names.index("R_Hip")
    lsho, rsho = names.index("L_Shoulder"), names.index("R_Shoulder")
    pelvis = 0.5 * (joints[:, lhip] + joints[:, rhip])
    pelvis[:, 2] = joints[:, lhip, 2] * joints[:, rhip, 2]
    neck = 0.5 * (joints[:, lsho] + joints[:, rsho])
    neck[:, 2] = joints[:, lsho, 2] * joints[:, rsho, 2]
    return np.concatenate(
        [joints, pelvis[:, None], neck[:, None]], axis=1)
