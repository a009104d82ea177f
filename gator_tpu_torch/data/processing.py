"""Host-side input preprocessing (numpy, explicit generator; counterpart of
gator_tpu/data/processing.py): the options of a dataset's 2D input, the
per-sample `crop_and_normalize_input` and the batched
`batch_crop_and_normalize` (GT input, Human3.6M Gaussian detector noise,
the COCO detector-noise simulator and test-time detections), the OKS crop
area that sets the simulator's radii, the stage-2 targets of one sample,
and `add_pelvis_neck_scores`. Mirrors the GATOR/GAT branches of the
reference's data/Human36M/dataset.py:339-419.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..assets.skeletons import JointSet
from . import augment, coords, noise


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


def crop_and_normalize_input(
    joint_img: np.ndarray,                 # [J, 2or3] pixel coords
    joint_set: JointSet,
    opts: ProcessOptions,
    rng: np.random.Generator,
    flip: int, rot: float,
    detected_pose: Optional[np.ndarray] = None,
    h36m_noise_stats: Optional[np.ndarray] = None,
    coco_noise_area: Optional[float] = None,
) -> np.ndarray:
    """Tight-bbox crop -> affine to input res -> optional detected/noisy
    replacement -> flip -> [0,1] + per-sample standardization
    (reference: Human36M/dataset.py:364-389,421-453)."""
    tight = coords.get_bbox(joint_img)
    aspect = opts.input_shape[1] / opts.input_shape[0]
    bbox = coords.process_bbox(tight, aspect)
    if bbox is None:
        bbox = np.array([0, 0, 1, 1], np.float32)
    proc, trans = augment.j2d_processing(
        joint_img.copy(), opts.res_wh, bbox, rot, 0, None)

    if not opts.use_gt_input:
        if detected_pose is not None:
            # test path: detector output mapped through the same crop
            det = detected_pose.copy().astype(np.float32)
            det[:, :2] = augment.affine_transform_batch(det[:, :2], trans)
            proc = det
        elif opts.input_joint_name == "human36" \
                and h36m_noise_stats is not None:
            err = noise.generate_h36m_syn_error(h36m_noise_stats, rng)
            err = err / 256.0 * np.array(
                [opts.input_shape[1], opts.input_shape[0]], np.float32)
            proc = proc[:, :2] + err
        elif opts.input_joint_name == "coco" \
                and coco_noise_area is not None:
            # synthesize detector noise on the first 17 coco keypoints in
            # crop space (reference: Human36M/dataset.py:424-432)
            kps = np.concatenate(
                [proc[:17, :2], np.ones((17, 1), np.float32)], axis=1)
            proc = proc.copy()
            proc[:17, :2] = noise.synthesize_pose(
                kps, coco_noise_area, rng)[:, :2]

    if flip:
        proc = augment.flip_2d_joint(
            proc[:, :2], opts.res_wh[0], joint_set.flip_pairs)
    return augment.normalize_input_pose(proc[:, :2], opts.input_shape)


def batch_crop_and_normalize(
    joint_img: np.ndarray,                 # [B, J, 2]
    joint_set: JointSet,
    opts: ProcessOptions,
    flip: np.ndarray,                      # [B] 0/1
    rot: np.ndarray,                       # [B] degrees
    h36m_noise: Optional[np.ndarray] = None,   # [B, J, 2] additive, or None
    coco_noise: Optional[Dict] = None,     # {"areas": [B], "rng": Generator}
    detected_pose: Optional[np.ndarray] = None,  # [B, J, 2+] test dets
) -> np.ndarray:
    """Vectorized `crop_and_normalize_input` for whole batches: GT-input,
    h36m-synthetic-noise, COCO detector-noise, and test-time detector
    replacement (the crop transform still comes from the GT joints'
    bbox; the detector keypoints ride through it —
    reference: Human36M/dataset.py:421-453).

    Math identical to the per-sample route: tight bbox -> aspect-snapped
    crop -> rotate-about-center affine -> optional noise -> optional flip ->
    [0,1] scaling -> per-sample standardization.
    """
    b = joint_img.shape[0]
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
    # scalar path's fallback crop (process_bbox -> None -> bbox
    # [0, 0, 1, 1]: center (0.5, 0.5), unit source width) instead of a
    # negative zoom / NaN standardization
    bad = (w < 1.0) | (h < 1.0)
    # aspect snap (coords.process_bbox math, vectorized)
    w = w - 1.0
    h = h - 1.0
    h = np.where(w > aspect * h, w / aspect, h)
    w = np.where(w < aspect * h, h * aspect, w)
    w = np.where(bad, 1.0, w)
    cx = np.where(bad, 0.5, cx)
    cy = np.where(bad, 0.5, cy)

    # affine: rotate about (cx, cy) by -rot (the reference's convention —
    # see augment.get_affine_transform), scale by res_w / w, recenter
    rad = np.pi * rot / 180.0
    cs, sn = np.cos(rad), np.sin(rad)
    k = res_w / w
    src = (joint_img if detected_pose is None
           else detected_pose[..., :2].astype(np.float32))
    rel = src - np.stack([cx, cy], axis=1)[:, None, :]
    xr = cs[:, None] * rel[..., 0] + sn[:, None] * rel[..., 1]
    yr = -sn[:, None] * rel[..., 0] + cs[:, None] * rel[..., 1]
    out = np.stack([xr * k[:, None] + res_w / 2.0,
                    yr * k[:, None] + res_h / 2.0], axis=-1)

    if h36m_noise is not None:
        out = out + h36m_noise
    if coco_noise is not None:
        # detector-noise synthesis on the 17 coco keypoints in crop space
        # (reference: Human36M/dataset.py:424-432); extra pelvis/neck rows
        # pass through untouched
        kps = np.concatenate(
            [out[:, :17], np.ones((b, 17, 1), np.float32)], axis=2)
        synth = noise.synthesize_pose_batch(
            kps, coco_noise["areas"], coco_noise["rng"])
        out = out.copy()
        out[:, :17] = synth[:, :, :2]
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


def crop_area_batch(joint_img: np.ndarray,
                    opts: ProcessOptions) -> np.ndarray:
    """Batched `crop_area` ([B, J, 2+] -> [B]): post-crop area of the
    TIGHT person bbox (the reference transforms the tight corners by the
    crop affine, Human36M/dataset.py:424-431). The affine maps the
    aspect-snapped bbox onto res_w x res_h with a uniform scale
    k = res_w / proc_w, so the transformed tight area is the closed form
    tight_w * tight_h * k^2 — pinned against the scalar/affine form in
    tests. Degenerate bboxes (process_bbox -> None) get area 1.0."""
    tight_w = joint_img[..., 0].max(1) - joint_img[..., 0].min(1)
    tight_h = joint_img[..., 1].max(1) - joint_img[..., 1].min(1)
    valid = (tight_w * tight_h > 0) & (tight_w >= 1) & (tight_h >= 1)
    res_w, _ = opts.res_wh
    aspect = opts.input_shape[1] / opts.input_shape[0]
    # process_bbox: w' = w-1, h' = h-1, snapped up to the model aspect
    proc_w = np.maximum(tight_w - 1.0, aspect * (tight_h - 1.0))
    k = float(res_w) / np.where(proc_w > 0, proc_w, 1.0)
    return np.where(valid, tight_w * tight_h * k * k, 1.0).astype(
        np.float32)


def crop_area(joint_img: np.ndarray, opts: ProcessOptions) -> float:
    """Area of the TIGHT person bbox after the crop transform — the OKS
    area driving detector-noise radii. The reference transforms the tight
    bbox corners (xmin,ymin)/(xmax,ymin)/(xmax,ymax) with the crop affine
    and multiplies the side lengths (reference: Human36M/dataset.py:424-431,
    called with tight_bbox at :371)."""
    tight = coords.get_bbox(joint_img)
    aspect = opts.input_shape[1] / opts.input_shape[0]
    bbox = coords.process_bbox(tight, aspect)
    if bbox is None:
        return 1.0
    _, trans = augment.j2d_processing(
        joint_img[:1].copy(), opts.res_wh, bbox, 0, 0, None)
    x0, y0, w, h = tight
    p1 = augment.affine_transform(np.array([x0, y0]), trans)
    p2 = augment.affine_transform(np.array([x0 + w, y0]), trans)
    p3 = augment.affine_transform(np.array([x0 + w, y0 + h]), trans)
    return float(np.linalg.norm(p2 - p1) * np.linalg.norm(p3 - p2))


def gator_targets(
    mesh_cam_mm: np.ndarray,               # [V, 3] root-relative, mm
    joint_cam_lift: np.ndarray,            # [J, 3] root-relative, mm
    joint_cam_h36m: np.ndarray,            # [17, 3] root-relative, mm
    fitting_error: float,
    opts: ProcessOptions,
    flip: int, rot: float,
    joint_set: JointSet,
) -> Dict[str, np.ndarray]:
    """Targets + validity masks for one stage-2 sample
    (reference: Human36M/dataset.py:391-407)."""
    joint_cam_lift = augment.j3d_processing(
        joint_cam_lift, rot, flip, joint_set.flip_pairs)
    v = mesh_cam_mm.shape[0]
    mesh_valid = np.ones((v, 1), np.float32)
    reg_valid = np.ones((17, 1), np.float32)
    lift_valid = np.ones((len(joint_cam_lift), 1), np.float32)
    if fitting_error > opts.fitting_thr:
        mesh_valid[:] = 0
        if opts.input_joint_name == "coco":
            lift_valid[:] = 0
    return {
        "mesh": (mesh_cam_mm / 1000.0).astype(np.float32),
        "lift_pose3d": joint_cam_lift.astype(np.float32),
        "reg_pose3d": joint_cam_h36m.astype(np.float32),
        "mesh_valid": mesh_valid,
        "reg_valid": reg_valid,
        "lift_valid": lift_valid,
    }


def add_pelvis_neck_scores(joints: np.ndarray, names) -> np.ndarray:
    """[N, 17, 3] (x, y, score) -> [N, 19, 3] with synthesized pelvis and
    neck; the synthesized score is the product of the parents'
    (reference: demo/run.py:103-121). Shared by the demo and serve CLIs."""
    lhip, rhip = names.index("L_Hip"), names.index("R_Hip")
    lsho, rsho = names.index("L_Shoulder"), names.index("R_Shoulder")
    pelvis = 0.5 * (joints[:, lhip] + joints[:, rhip])
    pelvis[:, 2] = joints[:, lhip, 2] * joints[:, rhip, 2]
    neck = 0.5 * (joints[:, lsho] + joints[:, rsho])
    neck[:, 2] = joints[:, lsho, 2] * joints[:, rsho, 2]
    return np.concatenate(
        [joints, pelvis[:, None], neck[:, None]], axis=1)
