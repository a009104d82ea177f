"""AMASS mocap reader, optional train data (counterpart of
gator_tpu/data/amass.py).

Loads `*_poses.npz` mocap files and places each frame before the four
fixed Human3.6M virtual cameras (reference: data/AMASS/dataset.py:99-177):
the CMU subset for GATOR training, CMU and BML for GAT; per-subset frame
subsampling. The GT joints are regressed from the synthesised mesh.
"""
from __future__ import annotations

import dataclasses
import glob
import os.path as osp
from typing import Dict

import numpy as np

from ..assets.bundle import GatorAssets
from . import processing
from .base import assemble_batch
from .gt_synth import GtSynthesizer

# the four fixed H36M camera rotations (reference: AMASS/dataset.py:100-104)
H36M_CAM_RS = np.array([
    [[-0.9153617, 0.40180838, 0.02574755],
     [0.05154812, 0.18037356, -0.9822465],
     [-0.39931902, -0.89778364, -0.18581952]],
    [[0.92816836, 0.37215385, 0.00224838],
     [0.08166409, -0.1977723, -0.9768404],
     [-0.36309022, 0.9068559, -0.2139576]],
    [[-0.91415495, -0.40277803, -0.04572295],
     [-0.04562341, 0.2143085, -0.97569996],
     [0.4027893, -0.8898549, -0.21428728]],
    [[0.91415626, -0.40060705, 0.06190599],
     [-0.05641001, -0.2769532, -0.9592262],
     [0.40141782, 0.8733905, -0.27577674]],
], dtype=np.float32)
CAM_T_M = np.array([0.0, 0.0, 10.0], np.float32)   # metres
FOCAL = np.array([1500.0, 1500.0], np.float32)
PRINCPT = np.array([500.0, 500.0], np.float32)

SUBSAMPLING = {"cmu": 60, "mpi_mosh": 10, "bmlrub": 10, "bmlmovi": 10}


@dataclasses.dataclass
class AmassTable:
    pose: np.ndarray     # [N, 72]
    shape: np.ndarray    # [N, 10]
    cam_r: np.ndarray    # [N, 3, 3]

    def __len__(self):
        return self.pose.shape[0]


class AmassDataset:
    name = "AMASS"

    def __init__(self, assets: GatorAssets, opts: processing.ProcessOptions,
                 data_dir: str, split: str = "train",
                 model_name: str = "GATOR", debug: bool = False):
        if split != "train":
            raise ValueError(f"AMASS has a train split only, not {split!r}")
        self.assets = assets
        self.opts = processing.ProcessOptions(
            **{**opts.__dict__, "is_train": True})
        self.joint_set = assets.joint_set
        self.table = self._load(osp.join(data_dir, "AMASS", "data"),
                                model_name, debug)

    @staticmethod
    def _load(data_path, model_name, debug) -> AmassTable:
        poses_list, shapes_list, cams_list = [], [], []
        for sub in sorted(glob.glob(f"{data_path}/*")):
            sub_name = osp.basename(sub)
            if model_name == "GATOR" and "CMU" not in sub_name:
                continue
            if model_name == "GAT" and ("CMU" not in sub_name
                                        and "BML" not in sub_name):
                continue
            sampling = SUBSAMPLING.get(sub_name.lower(), 5)
            for seq in sorted(glob.glob(f"{sub}/*")):
                for file in sorted(glob.glob(f"{seq}/*_poses.npz")):
                    data = np.load(file)
                    poses = data["poses"]
                    betas = data["betas"][:10]
                    for fi in np.arange(0, len(poses), sampling):
                        pose = poses[fi, :72].astype(np.float32)
                        for r in H36M_CAM_RS:
                            poses_list.append(pose)
                            shapes_list.append(betas.astype(np.float32))
                            cams_list.append(r)
                if debug:
                    break
        if not poses_list:
            raise ValueError(f"no AMASS mocap found under {data_path}")
        return AmassTable(pose=np.stack(poses_list),
                          shape=np.stack(shapes_list),
                          cam_r=np.stack(cams_list))

    def __len__(self):
        return len(self.table)

    def make_batch(self, indices, synth: GtSynthesizer,
                   rng: np.random.Generator,
                   stage: str = "gator") -> Dict[str, object]:
        """One batch: the mesh stays on the synthesizer's device; the COCO
        and h36m joints come to the host. Mocap GT is exact: no fitting
        filter (the reference keeps every sample)."""
        t = self.table
        idx = np.asarray(indices)
        n = len(idx)
        mesh_mm, _ = synth.smpl_mesh_rotated(
            t.pose[idx], t.shape[idx], t.cam_r[idx], np.tile(CAM_T_M, (n, 1)))
        # the reference projects metre-scale coords (AMASS:238 divides mm
        # by 1000 before cam2pixel): the same as projecting mm coords
        coco_cam, coco_img = synth.coco_from_mesh(
            mesh_mm, np.tile(FOCAL, (n, 1)), np.tile(PRINCPT, (n, 1)))
        h36m_dev = synth.h36m_from_mesh(mesh_mm)
        mesh_rel_m = synth.mesh_rel_m(mesh_mm, h36m_dev[:, :1])
        coco_cam, coco_img = coco_cam.cpu().numpy(), coco_img.cpu().numpy()
        h36m_cam = h36m_dev.cpu().numpy()

        opts = self.opts
        jh = h36m_cam - h36m_cam[:, :1]
        if opts.input_joint_name == "coco":
            joint_img_b = coco_img[:, :, :2]
            joint_cam_b = coco_cam - coco_cam[:, -2:-1]
        else:
            xy = (h36m_cam[..., :2] / h36m_cam[..., 2:3]
                  * FOCAL[None, None] + PRINCPT[None, None])
            joint_img_b, joint_cam_b = xy.astype(np.float32), jh
        return assemble_batch(
            opts, self.joint_set, rng, stage,
            mesh_rel_m=mesh_rel_m, joint_img_b=joint_img_b,
            joint_cam_b=joint_cam_b, reg_pose=jh, fit_err=None)
