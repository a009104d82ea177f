"""3DPW reader and evaluation, test only (counterpart of
gator_tpu/data/pw3d.py).

Parses `3DPW_latest_{split}.json` (COCO format) and the DarkPose detected
keypoints `darkpose_3dpw_{split}set_output.json` keyed by annotation id
(reference: data/PW3D/dataset.py:104-166). Gendered SMPL with the
translation applied inside the layer; GT h36m/coco joints regressed from
the GT mesh, which stays on the synthesizer's device; evaluation = H36M
MPJPE / PA-MPJPE (14 joints), SMPL MPJPE and MPVPE (reference:
PW3D/dataset.py:322-441), on the device of the tensors it is given.
"""
from __future__ import annotations

import dataclasses
import json
import os.path as osp
from typing import Dict

import numpy as np
import torch

from .. import metrics
from ..assets.bundle import GatorAssets
from . import coords, processing
from .base import GENDERS
from .gt_synth import GtSynthesizer
from .h36m import as_f32, joint_errors, regress

# the 14-joint h36m eval subset, whatever the input joint set
# (reference: PW3D/dataset.py:46)
EVAL_JOINTS = [1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16]


@dataclasses.dataclass
class Pw3dTable:
    pose: np.ndarray        # [N, 72]
    shape: np.ndarray       # [N, 10]
    trans: np.ndarray       # [N, 3]
    gender: np.ndarray      # [N] int
    focal: np.ndarray       # [N, 2]
    princpt: np.ndarray     # [N, 2]
    pred_pose2d: np.ndarray  # [N, 19, 3] darkpose + pelvis/neck
    vid_id: np.ndarray      # [N] video index (for accel metrics)

    def __len__(self):
        return self.pose.shape[0]


def _add_pelvis_neck(joints, names, only_pelvis=False):
    """(reference: PW3D/dataset.py:168-183)."""
    pelvis = 0.5 * (joints[names.index("L_Hip")]
                    + joints[names.index("R_Hip")])
    neck = 0.5 * (joints[names.index("L_Shoulder")]
                  + joints[names.index("R_Shoulder")])
    parts = [joints, pelvis[None]]
    if not only_pelvis:
        parts.append(neck[None])
    return np.concatenate(parts)


class PW3D:
    name = "PW3D"

    def __init__(self, assets: GatorAssets, opts: processing.ProcessOptions,
                 data_dir: str, split: str = "test"):
        self.assets = assets
        self.opts = processing.ProcessOptions(
            **{**opts.__dict__, "is_train": False})
        self.joint_set = assets.joint_set
        self.split = split
        self.table = self._load(data_dir, split)

    def _load(self, data_dir, split) -> Pw3dTable:
        data_path = osp.join(data_dir, "PW3D", "data")
        with open(osp.join(data_path, f"3DPW_latest_{split}.json")) as f:
            db = json.load(f)
        with open(osp.join(data_path,
                           f"darkpose_3dpw_{split}set_output.json")) as f:
            det = {str(item["annotation_id"]):
                   np.array(item["keypoints"], np.float32)[:, :3]
                   for item in json.load(f)}

        images = {img["id"]: img for img in db["images"]}
        gender_code = {"neutral": 0, "female": 1, "male": 2, "f": 1, "m": 2}
        h, w = self.opts.input_shape
        aspect = w / h
        rows = []
        for ann in db["annotations"]:
            img = images[ann["image_id"]]
            smpl_param = ann["smpl_param"]
            cam = {k: np.array(v, np.float32)
                   for k, v in img["cam_param"].items()}
            # bbox sanity filter (reference: PW3D/dataset.py:135-136)
            if "bbox" in ann and coords.process_bbox(
                    np.array(ann["bbox"], np.float32), aspect) is None:
                continue
            custom = det.get(str(ann["id"]))
            if custom is None:
                continue
            custom = _add_pelvis_neck(
                custom, list(self.joint_set.joints_name))
            rows.append(dict(
                sort_key=(ann["person_id"],
                          osp.join(img["sequence"], img["file_name"])),
                pose=np.array(smpl_param["pose"], np.float32).reshape(72),
                shape=np.array(smpl_param["shape"],
                               np.float32).reshape(-1)[:10],
                trans=np.array(smpl_param["trans"], np.float32).reshape(3),
                gender=gender_code.get(str(smpl_param.get(
                    "gender", "neutral")).lower(), 0),
                focal=cam["focal"].reshape(2),
                princpt=cam["princpt"].reshape(2),
                pred=custom.astype(np.float32),
                vid=img["sequence"] + str(ann["person_id"]),
            ))
        rows.sort(key=lambda r: r["sort_key"])
        if not rows:
            raise ValueError("3DPW annotations produced no usable samples")
        vids = {v: i for i, v in enumerate(
            dict.fromkeys(r["vid"] for r in rows))}
        return Pw3dTable(
            pose=np.stack([r["pose"] for r in rows]),
            shape=np.stack([r["shape"] for r in rows]),
            trans=np.stack([r["trans"] for r in rows]),
            gender=np.array([r["gender"] for r in rows], np.int64),
            focal=np.stack([r["focal"] for r in rows]),
            princpt=np.stack([r["princpt"] for r in rows]),
            pred_pose2d=np.stack([r["pred"] for r in rows]),
            vid_id=np.array([vids[r["vid"]] for r in rows], np.int64),
        )

    def __len__(self):
        return len(self.table)

    def synthesize_gt(self, indices, synth: GtSynthesizer) -> torch.Tensor:
        """GT meshes [B, V, 3] (mm) of the given rows on the synthesizer's
        device, one SMPL pass per gender, no |beta| > 3 cleaning
        (reference: PW3D/dataset.py:84-102,222-231)."""
        t = self.table
        idx = np.asarray(indices)
        mesh = torch.empty((len(idx), self.assets.mean_vertices.shape[0], 3),
                           device=synth.device)
        for g_code, g_name in enumerate(GENDERS):
            sel = np.nonzero(t.gender[idx] == g_code)[0]
            if len(sel) == 0:
                continue
            sub = idx[sel]
            part, _ = synth.smpl_mesh_direct(t.pose[sub], t.shape[sub],
                                             t.trans[sub], g_name, False)
            mesh[torch.as_tensor(sel, device=synth.device)] = part
        return mesh

    def make_batch(self, indices, synth: GtSynthesizer,
                   rng: np.random.Generator,
                   stage: str = "gator") -> Dict[str, object]:
        """One test batch: the GT mesh stays on the device (root-relative,
        metres); the regressed joints come to the host for the 2D input
        (the projected COCO joints, or the detections) and the targets."""
        t = self.table
        idx = np.asarray(indices)
        b = len(idx)
        mesh_mm = self.synthesize_gt(idx, synth)
        coco_cam, coco_img = synth.coco_from_mesh(
            mesh_mm, t.focal[idx], t.princpt[idx])
        h36m_dev = synth.h36m_from_mesh(mesh_mm)
        coco_cam, coco_img = coco_cam.cpu().numpy(), coco_img.cpu().numpy()
        h36m_cam = h36m_dev.cpu().numpy()
        opts = self.opts
        joint_img = coco_img if opts.use_gt_input else t.pred_pose2d[idx]
        pose2d = np.stack([
            processing.crop_and_normalize_input(
                joint_img[row, :, :2], self.joint_set, opts, rng, 0, 0.0)
            for row in range(b)])
        cc = (coco_cam - coco_cam[:, -2:-1]).astype(np.float32)
        ones = np.ones((b, 1, 1), np.float32)
        if stage != "gator":
            return {"pose2d": pose2d, "joint_cam": cc, "joint_valid": ones}
        return {
            "pose2d": pose2d,
            "mesh": synth.mesh_rel_m(mesh_mm, h36m_dev[:, :1]),
            "lift_pose3d": cc,
            "reg_pose3d": (h36m_cam - h36m_cam[:, :1]).astype(np.float32),
            "mesh_valid": ones, "reg_valid": ones, "lift_valid": ones,
        }

    def evaluate(self, pred_mesh_mm, gt_mesh_mm,
                 verbose: bool = True) -> Dict[str, float]:
        """[N, V, 3] meshes in mm (host arrays, or tensors on the device to
        run on) -> H36M MPJPE / PA-MPJPE, SMPL MPJPE, MPVPE
        (reference: PW3D/dataset.py:322-441)."""
        pm = as_f32(pred_mesh_mm)
        gm = as_f32(gt_mesh_mm, pm.device)
        pj = regress(self.assets.j_regressor_smpl, pm)
        gj = regress(self.assets.j_regressor_smpl, gm)
        pm0, gm0 = pm - pj[:, :1], gm - gj[:, :1]
        smpl_mpjpe = float(torch.sqrt((((pj - pj[:, :1])
                                        - (gj - gj[:, :1])) ** 2)
                                      .sum(-1)).mean())
        mpvpe = float(torch.sqrt(((pm0 - gm0) ** 2).sum(-1)).mean())
        ph = regress(self.assets.j_regressor_h36m, pm0)
        gh = regress(self.assets.j_regressor_h36m, gm0)
        per_joint, pa_per_joint = joint_errors(
            (ph - ph[:, :1])[:, EVAL_JOINTS], (gh - gh[:, :1])[:, EVAL_JOINTS])
        mpjpe, pa_mpjpe = float(per_joint.mean()), float(pa_per_joint.mean())
        out = {"mpjpe": mpjpe, "pa_mpjpe": pa_mpjpe,
               "smpl_mpjpe": smpl_mpjpe, "mpvpe": mpvpe}
        if verbose:
            print(f"H36M MPJPE (mm)    >> tot: {mpjpe:.2f}")
            print(f"H36M PA-MPJPE (mm) >> tot: {pa_mpjpe:.2f}")
            print(f"SMPL MPJPE (mm)    >> tot: {smpl_mpjpe:.2f}")
            print(f"MPVPE (mm)         >> tot: {mpvpe:.2f}")
        return out

    def accel_errors(self, pred_joints_by_video):
        """Per-video acceleration error over [(pred [N, J, 3], gt [N, J, 3])]
        (the reference keeps this path in a commented block,
        PW3D/dataset.py:383-417)."""
        return [float(metrics.accel_error(as_f32(gt), as_f32(pred)).mean())
                for pred, gt in pred_joints_by_video]
