"""MuCo-3DHP reader, train only (counterpart of gator_tpu/data/muco.py).

A multi-person composited dataset: per image the person closest to the
camera is kept (reference: data/MuCo/dataset.py:138-141); SMPL parameters
per annotation with NaN filtering (:169-177); GT joints regressed from the
fitted mesh and projected with the full camera; fitting filter 45 mm
against the MuCo annotation joints transferred to the h36m joint set
(:30,246-262; the reference passes mesh-regressed joints into that filter,
which would index out of bounds, so the annotation joints are used, the
evident intent, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
import json
import os.path as osp
from typing import Dict

import numpy as np
import torch

from ..assets.bundle import GatorAssets
from ..precision import no_tf32
from . import coords, processing
from .base import assemble_batch
from .gt_synth import GtSynthesizer

MUCO_JOINTS_NAME = (
    "Head_top", "Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "L_Shoulder",
    "L_Elbow", "L_Wrist", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee",
    "L_Ankle", "Pelvis", "Spine", "Head", "R_Hand", "L_Hand", "R_Toe",
    "L_Toe")
MUCO_ROOT_IDX = MUCO_JOINTS_NAME.index("Pelvis")
H36M_NAMES = (
    "Pelvis", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee", "L_Ankle",
    "Torso", "Neck", "Nose", "Head", "L_Shoulder", "L_Elbow", "L_Wrist",
    "R_Shoulder", "R_Elbow", "R_Wrist")
# the static muco -> h36m transfer (-1: no muco joint of that name)
H36M_FROM_MUCO = np.array([MUCO_JOINTS_NAME.index(n)
                           if n in MUCO_JOINTS_NAME else -1
                           for n in H36M_NAMES])


@dataclasses.dataclass
class MucoTable:
    pose: np.ndarray        # [N, 72]
    shape: np.ndarray       # [N, 10]
    trans: np.ndarray       # [N, 3]
    focal: np.ndarray       # [N, 2]
    princpt: np.ndarray     # [N, 2]
    joint_cam_muco: np.ndarray  # [N, 21, 3]

    def __len__(self):
        return self.pose.shape[0]


class MucoDataset:
    name = "MuCo"
    fitting_thr = 45.0   # mm (reference: MuCo/dataset.py:30)

    def __init__(self, assets: GatorAssets, opts: processing.ProcessOptions,
                 data_dir: str, split: str = "train"):
        if split != "train":
            raise ValueError(f"MuCo has a train split only, not {split!r}")
        self._bind(assets, opts)
        self.table = self._load(data_dir)

    @classmethod
    def from_table(cls, assets: GatorAssets,
                   opts: processing.ProcessOptions, table: MucoTable):
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

    def _load(self, data_dir) -> MucoTable:
        base = osp.join(data_dir, "MuCo", "data")
        with open(osp.join(base, "MuCo-3DHP.json")) as f:
            db = json.load(f)
        with open(osp.join(base, "smpl_param.json")) as f:
            smpl_params = json.load(f)

        anns_by_img: Dict[int, list] = {}
        for ann in db["annotations"]:
            anns_by_img.setdefault(ann["image_id"], []).append(ann)
        images = {img["id"]: img for img in db["images"]}

        aspect = self.opts.input_shape[1] / self.opts.input_shape[0]
        rows = []
        for iid, anns in anns_by_img.items():
            img = images[iid]
            # the person closest to the camera (reference: :138-141)
            depths = [a["keypoints_cam"][MUCO_ROOT_IDX][2] for a in anns]
            ann = anns[int(np.argmin(depths))]
            if coords.process_bbox(np.array(ann["bbox"]), aspect) is None:
                continue
            param = smpl_params.get(str(ann["id"]))
            if param is None:
                continue
            pose = np.array(param["pose"], np.float32).reshape(72)
            shape = np.array(param["shape"], np.float32).reshape(-1)[:10]
            trans = np.array(param["trans"], np.float32).reshape(3)
            if np.isnan(pose.sum() + shape.sum() + trans.sum()):
                continue
            rows.append(dict(
                pose=pose, shape=shape, trans=trans,
                focal=np.array(img["f"], np.float32).reshape(2),
                princpt=np.array(img["c"], np.float32).reshape(2),
                joint_cam=np.array(ann["keypoints_cam"],
                                   np.float32).reshape(21, 3),
            ))
        if not rows:
            raise ValueError("MuCo annotations produced no usable samples")
        return MucoTable(
            pose=np.stack([r["pose"] for r in rows]),
            shape=np.stack([r["shape"] for r in rows]),
            trans=np.stack([r["trans"] for r in rows]),
            focal=np.stack([r["focal"] for r in rows]),
            princpt=np.stack([r["princpt"] for r in rows]),
            joint_cam_muco=np.stack([r["joint_cam"] for r in rows]),
        )

    def __len__(self):
        return len(self.table)

    def _fitting_error_batch(self, muco_joints: np.ndarray,
                             mesh_mm: torch.Tensor) -> np.ndarray:
        """Translation-aligned error [B] (mm) of the mesh's regressed h36m
        joints against the muco -> h36m transferred annotation joints, on
        the mesh's device, TF32 off (reference: MuCo/dataset.py:246-262)."""
        no_tf32()
        mask = H36M_FROM_MUCO >= 0
        rel = muco_joints - muco_joints[:, MUCO_ROOT_IDX:MUCO_ROOT_IDX + 1]
        dev = mesh_mm.device
        gt = torch.as_tensor(rel[:, H36M_FROM_MUCO[mask]], dtype=torch.float32,
                             device=dev)
        jreg = torch.as_tensor(self.assets.j_regressor_h36m[mask],
                               dtype=torch.float32, device=dev)
        reg = torch.einsum("jv,bvc->bjc", jreg, mesh_mm)
        reg = reg - reg.mean(1, keepdim=True) + gt.mean(1, keepdim=True)
        return torch.sqrt(((gt - reg) ** 2).sum(-1)).mean(-1).cpu().numpy()

    def packed_rows(self, synth: GtSynthesizer, indices):
        """The rows of the packed table (data/packed.py)."""
        from .packed import muco_packed_rows
        return muco_packed_rows(self, synth, indices)

    def make_packed_batch(self, indices, rng):
        """Host batch of the packed pipeline (data/packed.py)."""
        from .packed import make_packed_batch
        return make_packed_batch(self, indices, rng)

    def make_batch(self, indices, synth: GtSynthesizer,
                   rng: np.random.Generator,
                   stage: str = "gator") -> Dict[str, object]:
        """One batch: the mesh stays on the synthesizer's device; the COCO
        and h36m joints and the fitting errors come to the host."""
        t = self.table
        idx = np.asarray(indices)
        mesh_mm, _ = synth.smpl_mesh_direct(
            t.pose[idx], t.shape[idx], t.trans[idx], "neutral", True)
        coco_cam, coco_img = synth.coco_from_mesh(
            mesh_mm, t.focal[idx], t.princpt[idx])
        h36m_dev = synth.h36m_from_mesh(mesh_mm)
        mesh_rel_m = synth.mesh_rel_m(mesh_mm, h36m_dev[:, :1])
        coco_cam, coco_img = coco_cam.cpu().numpy(), coco_img.cpu().numpy()
        h36m_cam = h36m_dev.cpu().numpy()

        opts = self.opts
        cc = coco_cam - coco_cam[:, -2:-1]
        jh = h36m_cam - h36m_cam[:, :1]
        if opts.input_joint_name == "coco":
            joint_img_b, joint_cam_b = coco_img[:, :, :2], cc
        else:
            # h36m input: the regressed h36m joints projected (cam2pixel)
            ji = (h36m_cam[..., :2] / h36m_cam[..., 2:3]
                  * t.focal[idx][:, None, :] + t.princpt[idx][:, None, :])
            joint_img_b, joint_cam_b = ji.astype(np.float32), jh
        fit_err = self._fitting_error_batch(t.joint_cam_muco[idx], mesh_mm)
        # MuCo zeroes every mask on a bad fit (reference: dataset.py:316-319)
        return assemble_batch(
            opts, self.joint_set, rng, stage,
            mesh_rel_m=mesh_rel_m, joint_img_b=joint_img_b,
            joint_cam_b=joint_cam_b, reg_pose=jh, fit_err=fit_err,
            bad_zero_gator=("mesh", "reg", "lift"), bad_zero_gat=False)
