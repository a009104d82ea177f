"""Deterministic synthetic dataset (counterpart of
gator_tpu/data/synthetic.py:122 `SyntheticDataset`): plausible random SMPL
parameters and virtual cameras drawn from a seed, in the same SmplTable and
batch contract as the real readers, so the eval path runs without the
external Human36M / 3DPW downloads.

The numpy draws are those of the JAX package in the same order, so one seed
gives both the same table; its "GT" h36m joints are regressed from the mesh
of the ported SMPL layer. The COCO and MuCo stand-ins (training only) are
not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..assets.bundle import GatorAssets
from . import processing
from .base import SmplPoseDataset, SmplTable
from .gt_synth import GtSynthesizer


def _virtual_camera(rng, n):
    """Simple look-at-ish cameras: small rotations about y, ~4-6 m away."""
    yaw = rng.uniform(-0.4, 0.4, n)
    cs, sn = np.cos(yaw), np.sin(yaw)
    r = np.zeros((n, 3, 3), np.float32)
    r[:, 0, 0], r[:, 0, 2] = cs, sn
    r[:, 1, 1] = 1
    r[:, 2, 0], r[:, 2, 2] = -sn, cs
    t = np.zeros((n, 3), np.float32)
    t[:, 2] = rng.uniform(4000, 6000, n)       # mm
    focal = np.full((n, 2), 1500.0, np.float32)
    princpt = np.full((n, 2), 500.0, np.float32)
    return r, t, focal, princpt


class SyntheticDataset(SmplPoseDataset):
    name = "Synthetic"

    def __init__(self, assets: GatorAssets, opts: processing.ProcessOptions,
                 n: int = 256, seed: int = 0,
                 synthesizer: Optional[GtSynthesizer] = None):
        """`synthesizer` (a new one on the card by default) synthesises the
        meshes that the table's GT joints are regressed from."""
        rng = np.random.default_rng(seed)
        pose = (0.25 * rng.standard_normal((n, 72))).astype(np.float32)
        pose[:, :3] = 0.1 * rng.standard_normal((n, 3))
        shape = rng.uniform(-1.5, 1.5, (n, 10)).astype(np.float32)
        trans = np.zeros((n, 3), np.float32)
        cam_r, cam_t, focal, princpt = _virtual_camera(rng, n)

        # dataset "GT" h36m joints regressed from the synthesized mesh, so
        # inputs and targets are geometrically consistent
        synth = synthesizer or GtSynthesizer(assets)
        mesh_mm, _ = synth.smpl_mesh_cam(pose, shape, trans, cam_r, cam_t,
                                         "neutral")
        joint_cam = synth.h36m_from_mesh(mesh_mm).cpu().numpy()
        xy = (joint_cam[..., :2] / joint_cam[..., 2:3] * focal[:, None]
              + princpt[:, None])
        table = SmplTable(
            pose=pose, shape=shape, trans=trans, cam_r=cam_r, cam_t=cam_t,
            focal=focal, princpt=princpt,
            joint_cam_h36m=joint_cam.astype(np.float32),
            joint_img_h36m=xy.astype(np.float32),
            gender=np.zeros(n, np.int64),
            meta={"cam_idx": np.full(n, 4, np.int64)},
        )
        super().__init__(assets, opts, table)
