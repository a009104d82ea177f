"""MSCOCO reader, train only (counterpart of gator_tpu/data/coco_ds.py).

Keypoint annotations and SMPLify fits (`person_keypoints_train2017.json`,
`coco_smplify_train.json`; reference: data/COCO/dataset.py:102-145). The GT
joints are regressed from the fitted mesh and projected with the fit's
weak-perspective (s, t) camera; the fitting filter is a 2D reprojection
error against the annotated keypoints inside a 64x64 crop, threshold 3.0
(reference: COCO/dataset.py:28,183-214).
"""
from __future__ import annotations

import dataclasses
import json
import os.path as osp
from typing import Dict

import numpy as np

from ..assets.bundle import GatorAssets
from . import coords, processing
from .base import assemble_batch
from .gt_synth import GtSynthesizer


@dataclasses.dataclass
class CocoTable:
    pose: np.ndarray         # [N, 72]
    shape: np.ndarray        # [N, 10]
    cam_s: np.ndarray        # [N, 1] weak-perspective scale
    cam_t: np.ndarray        # [N, 2] weak-perspective translation
    joint_img: np.ndarray    # [N, 17, 2] annotated keypoints (pixels)
    joint_valid: np.ndarray  # [N, 17, 1]
    bbox: np.ndarray         # [N, 4] annotation bbox (for fitting error)

    def __len__(self):
        return self.pose.shape[0]


class CocoDataset:
    name = "COCO"
    fitting_thr = 3.0   # 64x64-crop pixels (reference: COCO/dataset.py:28)

    def __init__(self, assets: GatorAssets, opts: processing.ProcessOptions,
                 data_dir: str, split: str = "train"):
        self._bind(assets, opts)
        self.table = self._load(data_dir, split)

    @classmethod
    def from_table(cls, assets: GatorAssets,
                   opts: processing.ProcessOptions, table: CocoTable):
        """A dataset over an in-memory table (the synthetic stand-in)."""
        ds = cls.__new__(cls)
        ds._bind(assets, opts)
        ds.table = table
        return ds

    def _bind(self, assets, opts):
        self.assets = assets
        self.opts = processing.ProcessOptions(
            **{**opts.__dict__, "fitting_thr": self.fitting_thr,
               "is_train": True})
        self.joint_set = assets.joint_set

    def _load(self, data_dir, split) -> CocoTable:
        annot_path = osp.join(data_dir, "COCO", "annotations")
        with open(osp.join(annot_path,
                           f"person_keypoints_{split}2017.json")) as f:
            db = json.load(f)
        with open(osp.join(annot_path, "coco_smplify_train.json")) as f:
            fits = json.load(f)

        aspect = self.opts.input_shape[1] / self.opts.input_shape[0]
        rows = []
        for ann in db["annotations"]:
            if ann.get("iscrowd") or ann.get("num_keypoints", 0) == 0:
                continue
            if coords.process_bbox(np.array(ann["bbox"]), aspect) is None:
                continue
            fit = fits.get(str(ann["id"]))
            if fit is None:
                continue
            kp = np.array(ann["keypoints"], np.float32).reshape(-1, 3)
            smpl_param = fit["smpl_param"]
            cam = fit["cam_param"]
            rows.append(dict(
                pose=np.array(smpl_param["pose"], np.float32).reshape(72),
                shape=np.array(smpl_param["shape"],
                               np.float32).reshape(-1)[:10],
                s=np.array(cam["s"], np.float32).reshape(-1)[:1],
                t=np.array(cam["t"], np.float32).reshape(2),
                joint_img=kp[:, :2],
                joint_valid=(kp[:, 2:3] > 0).astype(np.float32),
                bbox=np.array(ann["bbox"], np.float32),
            ))
        if not rows:
            raise ValueError("COCO annotations produced no usable samples")
        return CocoTable(
            pose=np.stack([r["pose"] for r in rows]),
            shape=np.stack([r["shape"] for r in rows]),
            cam_s=np.stack([r["s"] for r in rows]),
            cam_t=np.stack([r["t"] for r in rows]),
            joint_img=np.stack([r["joint_img"] for r in rows]),
            joint_valid=np.stack([r["joint_valid"] for r in rows]),
            bbox=np.stack([r["bbox"] for r in rows]),
        )

    def __len__(self):
        return len(self.table)

    @staticmethod
    def _fitting_error_2d_batch(bboxes, kp_dataset, kp_valid, kp_from_smpl):
        """2D reprojection error inside a 64x64 square crop, batched
        (reference: COCO/dataset.py:196-214). The crop affine is a pure
        similarity (rotation 0), so the translation cancels and the error
        is (64 / square bbox width) times the mean valid keypoint distance
        in image space; inf where the bbox is degenerate or no keypoint is
        valid."""
        w = bboxes[:, 2] - 1.0
        h = bboxes[:, 3] - 1.0
        wsq = np.maximum(w, h)
        ok = (bboxes[:, 2] * bboxes[:, 3] > 0) \
            & (bboxes[:, 2] >= 1) & (bboxes[:, 3] >= 1)
        d = np.linalg.norm(
            kp_dataset[..., :2] - kp_from_smpl[..., :2], axis=-1)
        m = kp_valid[..., 0] == 1
        cnt = m.sum(-1)
        mean_d = (d * m).sum(-1) / np.maximum(cnt, 1)
        scale = 64.0 / np.maximum(wsq, 1e-9)
        return np.where(ok & (cnt > 0), scale * mean_d,
                        np.inf).astype(np.float32)

    def packed_rows(self, synth: GtSynthesizer, indices):
        """The rows of the packed table (data/packed.py)."""
        from .packed import coco_packed_rows
        return coco_packed_rows(self, synth, indices)

    def make_packed_batch(self, indices, rng):
        """Host batch of the packed pipeline (data/packed.py)."""
        from .packed import make_packed_batch
        return make_packed_batch(self, indices, rng)

    def make_batch(self, indices, synth: GtSynthesizer,
                   rng: np.random.Generator,
                   stage: str = "gator") -> Dict[str, object]:
        """One batch: the mesh stays on the synthesizer's device; the COCO
        and h36m joints come to the host for the 2D input, the lift and
        regression targets and the fitting filter."""
        t = self.table
        idx = np.asarray(indices)
        mesh_mm, _ = synth.smpl_mesh_plain(t.pose[idx], t.shape[idx])
        coco_cam, coco_img = synth.coco_weak_perspective(
            mesh_mm, t.cam_s[idx], t.cam_t[idx])
        h36m_dev = synth.h36m_from_mesh(mesh_mm)
        mesh_rel_m = synth.mesh_rel_m(mesh_mm, h36m_dev[:, :1])
        coco_cam, coco_img = coco_cam.cpu().numpy(), coco_img.cpu().numpy()
        h36m_cam = h36m_dev.cpu().numpy()

        fit_err = self._fitting_error_2d_batch(
            t.bbox[idx], t.joint_img[idx], t.joint_valid[idx],
            coco_img[:, :17])
        # COCO zeroes every validity mask on a bad fit (dataset.py:270)
        return assemble_batch(
            self.opts, self.joint_set, rng, stage,
            mesh_rel_m=mesh_rel_m, joint_img_b=coco_img[:, :, :2],
            joint_cam_b=coco_cam - coco_cam[:, -2:-1],
            reg_pose=h36m_cam - h36m_cam[:, :1], fit_err=fit_err,
            bad_zero_gator=("mesh", "reg", "lift"), bad_zero_gat=True)
