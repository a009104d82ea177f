"""Host-side coordinate and bbox utilities (numpy; counterpart of
gator_tpu/data/coords.py, reference: lib/coord_utils.py): bbox
processing, camera projections, and the per-sample similarity Procrustes."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def get_center_scale(box) -> Tuple[np.ndarray, np.ndarray]:
    """bbox (x, y, w, h) -> (center [2], scale [2])
    (reference: coord_utils.py:7-18)."""
    x, y, w, h = box
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    scale = np.array([w, h], dtype=np.float32)
    return center, scale


def get_bbox(joint_img: np.ndarray) -> np.ndarray:
    """Tight bbox around 2D joints, (x, y, w, h)
    (reference: coord_utils.py:21-39)."""
    x, y = joint_img[:, 0], joint_img[:, 1]
    xmin, xmax = float(x.min()), float(x.max())
    ymin, ymax = float(y.min()), float(y.max())
    return np.array([xmin, ymin, xmax - xmin, ymax - ymin], dtype=np.float32)


def process_bbox(bbox, aspect_ratio: float, scale: float = 1.0
                 ) -> Optional[np.ndarray]:
    """Snap a bbox to the model input's aspect ratio (input_w / input_h),
    centred; None for a degenerate box (reference: coord_utils.py:42-66)."""
    x, y, w, h = bbox
    x2, y2 = x + (w - 1), y + (h - 1)
    if not (w * h > 0 and x2 >= x and y2 >= y):
        return None
    bbox = np.array([x, y, x2 - x, y2 - y], dtype=np.float32)
    w, h = bbox[2], bbox[3]
    cx, cy = bbox[0] + w / 2.0, bbox[1] + h / 2.0
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    return np.array([cx - w * scale / 2.0, cy - h * scale / 2.0,
                     w * scale, h * scale], dtype=np.float32)


def cam2pixel(cam_coord: np.ndarray, f, c) -> np.ndarray:
    """[N, 3] camera coords -> [N, 3] (x_img, y_img, z_cam)
    (reference: coord_utils.py:104-109)."""
    x = cam_coord[:, 0] / cam_coord[:, 2] * f[0] + c[0]
    y = cam_coord[:, 1] / cam_coord[:, 2] * f[1] + c[1]
    return np.stack([x, y, cam_coord[:, 2]], axis=1)


def world2cam(world_coord: np.ndarray, R, t) -> np.ndarray:
    """(reference: coord_utils.py:112-114)."""
    return world_coord @ np.asarray(R).T + np.asarray(t).reshape(1, 3)


def pixel2cam(coords: np.ndarray, c, f) -> np.ndarray:
    """(reference: coord_utils.py:117-124)."""
    out = np.zeros((len(coords), 3))
    z = coords[..., 2].reshape(-1, 1)
    out[..., :2] = (coords[..., :2] - c) * z / f
    out[..., 2] = coords[..., 2]
    return out


def rigid_align_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Align the [N, 3] points `a` to `b` by a similarity transform, one
    sample on the host: the per-sample form of `metrics.procrustes_align`
    (reference: lib/coord_utils.py:127-149)."""
    n = a.shape[0]
    ca, cb = a.mean(0), b.mean(0)
    h = (a - ca).T @ (b - cb) / n
    u, s, vh = np.linalg.svd(h)
    r = vh.T @ u.T
    if np.linalg.det(r) < 0:
        s[-1] = -s[-1]
        vh[2] = -vh[2]
        r = vh.T @ u.T
    var = np.var(a, axis=0).sum()
    c = s.sum() / var
    t = -(c * r) @ ca + cb
    return (c * r @ a.T).T + t
