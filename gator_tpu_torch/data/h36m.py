"""Human3.6M reader and evaluation (counterpart of gator_tpu/data/h36m.py).

Parses the reference's annotation files
(`Human36M_subject{S}_{data,camera,joint_3d,smpl_param}.json`, and
`absnet_output_on_testset.json` for detected test input) into an SoA table
(reference: data/Human36M/dataset.py:157-252). Protocol behaviour kept:
protocol 2 subjects (train 1/5/6/7/8, test 9/11), frame subsampling 5/50,
fitting threshold 25 mm, final evaluation on camera 4 with the 14-joint
subset and a per-action breakdown (reference: dataset.py:33,108-133,
515-636). The metric suite runs on the device of the tensors it is given,
in true f32 (TF32 off).
"""
from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List

import numpy as np
import torch

from .. import metrics
from ..assets.bundle import GatorAssets
from ..precision import no_tf32
from . import coords, processing
from .base import SmplPoseDataset, SmplTable

ACTION_NAMES = (
    "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Posing",
    "Purchases", "Sitting", "SittingDown", "Smoking", "Photo", "Waiting",
    "Walking", "WalkDog", "WalkTogether")

SUBJECTS = {  # (protocol, split) -> subject list
    (1, "train"): (1, 5, 6, 7, 8, 9), (1, "test"): (11,),
    (2, "train"): (1, 5, 6, 7, 8), (2, "test"): (9, 11),
}
SAMPLING = {"train": 5, "test": 50}


def as_f32(x, device=None) -> torch.Tensor:
    """A host array or a tensor as f32; a tensor keeps its device unless
    one is named."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def regress(j_regressor: np.ndarray, mesh: torch.Tensor) -> torch.Tensor:
    """[J, V] regressor over [B, V, 3] meshes -> [B, J, 3], on the mesh's
    device, TF32 off."""
    no_tf32()
    return torch.einsum("jv,bvc->bjc", as_f32(j_regressor, mesh.device),
                        mesh)


def joint_errors(pred: torch.Tensor, gt: torch.Tensor):
    """-> per-joint errors [B, J] before and after Procrustes alignment."""
    per_joint = torch.sqrt(((pred - gt) ** 2).sum(-1))
    aligned = metrics.procrustes_align(pred, gt)
    return per_joint, torch.sqrt(((aligned - gt) ** 2).sum(-1))


class Human36M(SmplPoseDataset):
    name = "Human36M"

    def __init__(self, assets: GatorAssets, opts: processing.ProcessOptions,
                 data_dir: str, split: str, protocol: int = 2,
                 debug: bool = False):
        opts = processing.ProcessOptions(
            **{**opts.__dict__, "fitting_thr": 25.0,
               "is_train": split == "train"})
        table, detected = self._load(data_dir, split, protocol, debug, opts)
        super().__init__(assets, opts, table, detected_pose=detected)
        self.split = split
        self.protocol = protocol

    # -- loading -----------------------------------------------------------

    def _load(self, data_dir, split, protocol, debug, opts):
        annot_path = osp.join(data_dir, "Human36M", "annotations")
        subjects = SUBJECTS[(protocol, split)]
        if debug:
            subjects = subjects[:1]
        sampling = SAMPLING[split]

        images: Dict[int, dict] = {}
        ann_list: List[dict] = []
        cameras, joints3d, smpl_params = {}, {}, {}
        for s in subjects:
            base = osp.join(annot_path, f"Human36M_subject{s}")
            with open(base + "_data.json") as f:
                annot = json.load(f)
            for img in annot["images"]:
                images[img["id"]] = img
            ann_list.extend(annot["annotations"])
            with open(base + "_camera.json") as f:
                cameras[str(s)] = json.load(f)
            with open(base + "_joint_3d.json") as f:
                joints3d[str(s)] = json.load(f)
            with open(base + "_smpl_param.json") as f:
                smpl_params[str(s)] = json.load(f)

        rows = []
        skip_img_names = []
        for ann in ann_list:
            img = images[ann["image_id"]]
            if img["frame_idx"] % sampling != 0:
                continue
            s, act, subact, frame = (str(img["subject"]),
                                     str(img["action_idx"]),
                                     str(img["subaction_idx"]),
                                     str(img["frame_idx"]))
            try:
                smpl_param = smpl_params[s][act][subact][frame]
            except KeyError:
                skip_img_names.append(img["file_name"].split("/")[-1])
                continue
            cam = cameras[s][str(img["cam_idx"])]
            r = np.array(cam["R"], np.float32)
            t = np.array(cam["t"], np.float32)
            f = np.array(cam["f"], np.float32)
            c = np.array(cam["c"], np.float32)
            joint_world = np.array(
                joints3d[s][act][subact][frame], np.float32)
            joint_cam = coords.world2cam(joint_world, r, t)
            joint_img = coords.cam2pixel(joint_cam, f, c)
            bbox = coords.process_bbox(
                np.array(ann["bbox"]),
                opts.input_shape[1] / opts.input_shape[0])
            if bbox is None:
                continue
            rows.append(dict(
                img_name=img["file_name"].split("/")[-1],
                pose=np.array(smpl_param["pose"], np.float32).reshape(72),
                shape=np.array(smpl_param["shape"], np.float32).reshape(10),
                trans=np.array(smpl_param["trans"], np.float32).reshape(3),
                cam_r=r, cam_t=t, focal=f, princpt=c,
                joint_cam=joint_cam.astype(np.float32),
                joint_img=joint_img[:, :2].astype(np.float32),
                cam_idx=img["cam_idx"], action_idx=int(act),
            ))
        rows.sort(key=lambda d: d["img_name"])

        def stack(key, shape):
            return (np.stack([r[key] for r in rows]) if rows
                    else np.zeros((0,) + shape, np.float32))

        table = SmplTable(
            pose=stack("pose", (72,)), shape=stack("shape", (10,)),
            trans=stack("trans", (3,)), cam_r=stack("cam_r", (3, 3)),
            cam_t=stack("cam_t", (3,)), focal=stack("focal", (2,)),
            princpt=stack("princpt", (2,)),
            joint_cam_h36m=stack("joint_cam", (17, 3)),
            joint_img_h36m=stack("joint_img", (17, 2)),
            gender=np.zeros(len(rows), np.int64),   # neutral for all
            meta={
                "cam_idx": np.array([r["cam_idx"] for r in rows], np.int64),
                "action_idx": np.array(
                    [r["action_idx"] for r in rows], np.int64),
            },
        )

        detected = None
        if split == "test" and not opts.use_gt_input:
            detected = self._load_detections(
                osp.join(data_dir, "Human36M",
                         "absnet_output_on_testset.json"),
                [r["img_name"] for r in rows], skip_img_names)
        return table, detected

    @staticmethod
    def _load_detections(path, img_names, skip_list):
        """Detected 2D test input, sorted by image name to align with the
        sorted rows (reference: dataset.py:89-99,448-453)."""
        with open(path) as f:
            data = json.load(f)
        det = [(img_path, np.array(pose2d, np.float32))
               for img_path, pose2d in data.items()
               if img_path not in skip_list]
        det.sort(key=lambda kv: kv[0])
        out = np.stack([p for _, p in det])
        if len(out) != len(img_names):
            raise ValueError(f"detection count {len(out)} != annotation "
                             f"count {len(img_names)} in {path}")
        return out[..., :2].astype(np.float32)

    # -- evaluation --------------------------------------------------------

    def _print_actions(self, title, rows, actions):
        for label, arr in rows:
            line = f"{title(label)} >> tot: {arr.mean():.2f}\n"
            for a, aname in enumerate(ACTION_NAMES):
                mask = actions[:len(arr)] == a
                if mask.any():
                    line += f"{aname}: {arr[mask].mean():.2f} "
            print(line)

    def evaluate(self, pred_mesh_mm, gt_mesh_mm, verbose: bool = True,
                 all_cameras: bool = False) -> Dict[str, float]:
        """Final H36M evaluation, [N, V, 3] meshes in mm (host arrays, or
        tensors on the device to run on): camera-4 rows only (all_cameras
        evaluates every view, the reference's dataset_test_all.py
        variant); H36M-regressed MPJPE / PA-MPJPE on the 14-joint subset
        against the annotated joints, SMPL-joint MPJPE and MPVPE against
        the GT mesh; per-action breakdown (reference: dataset.py:515-636,
        dataset_test_all.py:23)."""
        cam_idx = self.table.meta["cam_idx"]
        sel = (np.arange(len(cam_idx)) if all_cameras
               else np.nonzero(cam_idx == 4)[0])
        pm = as_f32(pred_mesh_mm)
        gm = as_f32(gt_mesh_mm, pm.device)
        pos = torch.as_tensor(sel, device=pm.device)
        pm, gm = pm[pos], gm[pos]
        ej = list(self.joint_set.eval_joints)

        pj = regress(self.assets.j_regressor_smpl, pm)
        gj = regress(self.assets.j_regressor_smpl, gm)
        pm0, gm0 = pm - pj[:, :1], gm - gj[:, :1]
        pj0, gj0 = pj - pj[:, :1], gj - gj[:, :1]
        smpl_mpjpe = float(torch.sqrt(((pj0 - gj0) ** 2).sum(-1)).mean())
        mpvpe = float(torch.sqrt(((pm0 - gm0) ** 2).sum(-1)).mean())

        ph = regress(self.assets.j_regressor_h36m, pm0)
        ph = (ph - ph[:, :1])[:, ej]
        gth = as_f32(self.table.joint_cam_h36m[sel], pm.device)
        gth = (gth - gth[:, :1])[:, ej]
        per_joint, pa_per_joint = joint_errors(ph, gth)
        out = {"mpjpe": float(per_joint.mean()),
               "pa_mpjpe": float(pa_per_joint.mean()),
               "smpl_mpjpe": smpl_mpjpe, "mpvpe": mpvpe}
        if verbose:
            self._print_actions(
                lambda label: f"Protocol {self.protocol} H36M pose error "
                              f"({label})",
                (("MPJPE", per_joint.cpu().numpy()),
                 ("PA-MPJPE", pa_per_joint.cpu().numpy())),
                self.table.meta["action_idx"][sel] - 2)
            print(f"SMPL MPJPE: {smpl_mpjpe:.2f}  MPVPE: {mpvpe:.2f}")
        return out

    def evaluate_joint(self, pred_joint_mm, gt_joint_mm,
                       verbose: bool = True) -> Dict[str, float]:
        """Stage-1 (GAT lifter) final evaluation: root-aligned MPJPE and
        PA-MPJPE over the 14 eval joints, no camera filter, batched
        Procrustes on the tensors' device (reference: dataset.py:480-513);
        per-action breakdown in `evaluate`'s format."""
        ej = list(self.joint_set.eval_joints)
        p = as_f32(pred_joint_mm)
        g = as_f32(gt_joint_mm, p.device)
        per_joint, pa_per_joint = joint_errors(
            (p - p[:, :1])[:, ej], (g - g[:, :1])[:, ej])
        out = {"mpjpe": float(per_joint.mean()),
               "pa_mpjpe": float(pa_per_joint.mean())}
        if verbose:
            self._print_actions(
                lambda label: f"{label} (mm)   ",
                (("MPJPE", per_joint.cpu().numpy()),
                 ("PA-MPJPE", pa_per_joint.cpu().numpy())),
                self.table.meta["action_idx"] - 2)
        return out
