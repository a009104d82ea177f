"""Host-side input preprocessing (numpy; counterpart of
gator_tpu/data/processing.py): the options of a dataset's 2D input, the
batched crop/flip/normalise of `batch_crop_and_normalize` (:82), and
`add_pelvis_neck_scores` (:240).

The detector-noise and test-time detector branches of
`batch_crop_and_normalize` and the per-sample forms are not ported yet
(the data-pipeline slice ports them with the readers that need them).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..assets.skeletons import JointSet


@dataclasses.dataclass(frozen=True)
class ProcessOptions:
    input_shape: Tuple[int, int] = (384, 288)    # (H, W)
    use_gt_input: bool = True
    fitting_thr: float = 25.0                    # mm; dataset-specific
    flip_enabled: bool = False
    rotate_factor: float = 0.0
    is_train: bool = True
    input_joint_name: str = "human36"

    @property
    def res_wh(self) -> Tuple[int, int]:
        return (self.input_shape[1], self.input_shape[0])


def batch_crop_and_normalize(
    joint_img: np.ndarray,                 # [B, J, 2] pixel coords
    joint_set: JointSet,
    opts: ProcessOptions,
    flip: np.ndarray,                      # [B] 0/1
    rot: np.ndarray,                       # [B] degrees
) -> np.ndarray:
    """[B, J, 2] pixel keypoints -> [B, J, 2] model input: tight bbox ->
    aspect-snapped crop -> rotate-about-centre affine -> optional flip ->
    [0, 1] -> per-sample standardisation (reference:
    Human36M/dataset.py:364-389, 421-453)."""
    res_w, res_h = opts.res_wh
    aspect = opts.input_shape[1] / opts.input_shape[0]

    x0 = joint_img[..., 0].min(axis=1)
    x1 = joint_img[..., 0].max(axis=1)
    y0 = joint_img[..., 1].min(axis=1)
    y1 = joint_img[..., 1].max(axis=1)
    w = x1 - x0
    h = y1 - y0
    cx, cy = x0 + (w - 1) / 2.0, y0 + (h - 1) / 2.0
    # degenerate tight boxes (all joints coincident on an axis) take the
    # fallback crop: centre (0.5, 0.5), unit source width
    bad = (w < 1.0) | (h < 1.0)
    w = w - 1.0
    h = h - 1.0
    h = np.where(w > aspect * h, w / aspect, h)
    w = np.where(w < aspect * h, h * aspect, w)
    w = np.where(bad, 1.0, w)
    cx = np.where(bad, 0.5, cx)
    cy = np.where(bad, 0.5, cy)

    # rotate about (cx, cy) by -rot (the reference's convention), scale by
    # res_w / w, recentre
    rad = np.pi * rot / 180.0
    cs, sn = np.cos(rad), np.sin(rad)
    k = res_w / w
    rel = joint_img - np.stack([cx, cy], axis=1)[:, None, :]
    xr = cs[:, None] * rel[..., 0] + sn[:, None] * rel[..., 1]
    yr = -sn[:, None] * rel[..., 0] + cs[:, None] * rel[..., 1]
    out = np.stack([xr * k[:, None] + res_w / 2.0,
                    yr * k[:, None] + res_h / 2.0], axis=-1)

    if flip.any():
        flipped = out.copy()
        flipped[..., 0] = res_w - flipped[..., 0] - 1
        pairs = np.asarray(joint_set.flip_pairs)
        if len(pairs):
            tmp = flipped[:, pairs[:, 0]].copy()
            flipped[:, pairs[:, 0]] = flipped[:, pairs[:, 1]]
            flipped[:, pairs[:, 1]] = tmp
        out = np.where(flip[:, None, None].astype(bool), flipped, out)

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
