"""Deterministic synthetic dataset (counterpart of
gator_tpu/data/synthetic.py:122 `SyntheticDataset`): plausible random SMPL
parameters and virtual cameras drawn from a seed, in the same SmplTable and
batch contract as the real readers, so the eval path runs without the
external Human36M / 3DPW downloads.

The numpy draws are those of the JAX package in the same order, so one seed
gives both the same table; its "GT" h36m joints are regressed from the mesh
of the ported SMPL layer. `synthetic_coco_dataset` and
`synthetic_muco_dataset` are the COCO and MuCo stand-ins of training
(gator_tpu/data/synthetic.py:30-121): their annotated keypoints come from
the device's SMPL pass, so they agree with the JAX package's to f32
rounding.
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


def _smpl_draws(rng, n):
    pose = (0.25 * rng.standard_normal((n, 72))).astype(np.float32)
    pose[:, :3] = 0.1 * rng.standard_normal((n, 3))
    shape = rng.uniform(-1.5, 1.5, (n, 10)).astype(np.float32)
    return pose, shape


def synthetic_coco_dataset(assets: GatorAssets,
                           opts: processing.ProcessOptions, n: int = 256,
                           seed: int = 0,
                           synthesizer: Optional[GtSynthesizer] = None):
    """An in-memory CocoDataset over a fabricated CocoTable
    (weak-perspective SMPLify-style fits), for the mixed flagship recipe
    without the COCO download. The annotated keypoints are the fit's own
    projected joints plus small noise, so the 2D fitting filter passes for
    most rows, as real COCO does after the reference's thr-3.0 filter."""
    from .coco_ds import CocoDataset, CocoTable

    rng = np.random.default_rng(seed + 101)
    pose, shape = _smpl_draws(rng, n)
    cam_s = rng.uniform(120.0, 180.0, (n, 1)).astype(np.float32)
    cam_t = rng.uniform(200.0, 400.0, (n, 2)).astype(np.float32)

    synth = synthesizer or GtSynthesizer(assets)
    mesh_mm, _ = synth.smpl_mesh_plain(pose, shape)
    _, coco_img = synth.coco_weak_perspective(mesh_mm, cam_s, cam_t)
    kp = coco_img[:, :17, :2].cpu().numpy()
    kp = kp + rng.normal(0, 0.5, kp.shape).astype(np.float32)
    x0, y0 = kp[..., 0].min(1), kp[..., 1].min(1)
    w = kp[..., 0].max(1) - x0 + 20.0
    h = kp[..., 1].max(1) - y0 + 20.0
    return CocoDataset.from_table(assets, opts, CocoTable(
        pose=pose, shape=shape, cam_s=cam_s, cam_t=cam_t,
        joint_img=kp.astype(np.float32),
        joint_valid=np.ones((n, 17, 1), np.float32),
        bbox=np.stack([x0 - 10, y0 - 10, w, h], axis=1).astype(np.float32)))


def synthetic_muco_dataset(assets: GatorAssets,
                           opts: processing.ProcessOptions, n: int = 256,
                           seed: int = 0,
                           synthesizer: Optional[GtSynthesizer] = None):
    """An in-memory MucoDataset over a fabricated MucoTable (full cameras,
    in-layer translation). The 21 MuCo annotation joints are filled from
    the synthesised mesh's regressed h36m joints (the entries the 45 mm
    fitting filter reads) plus small noise."""
    from .muco import H36M_NAMES, MUCO_JOINTS_NAME, MucoDataset, MucoTable

    rng = np.random.default_rng(seed + 202)
    pose, shape = _smpl_draws(rng, n)
    trans = np.zeros((n, 3), np.float32)
    trans[:, 2] = rng.uniform(3.0, 5.0, n)          # metres
    focal = np.full((n, 2), 1500.0, np.float32)
    princpt = np.full((n, 2), 1000.0, np.float32)

    synth = synthesizer or GtSynthesizer(assets)
    mesh_mm, _ = synth.smpl_mesh_direct(pose, shape, trans, "neutral", True)
    h36m = synth.h36m_from_mesh(mesh_mm).cpu().numpy()
    joint_cam = np.zeros((n, 21, 3), np.float32)
    for mi, name in enumerate(MUCO_JOINTS_NAME):
        if name in H36M_NAMES:
            joint_cam[:, mi] = h36m[:, H36M_NAMES.index(name)]
    joint_cam += rng.normal(0, 2.0, joint_cam.shape).astype(np.float32)
    return MucoDataset.from_table(assets, opts, MucoTable(
        pose=pose, shape=shape, trans=trans, focal=focal, princpt=princpt,
        joint_cam_muco=joint_cam))


class SyntheticDataset(SmplPoseDataset):
    name = "Synthetic"

    def __init__(self, assets: GatorAssets, opts: processing.ProcessOptions,
                 n: int = 256, seed: int = 0,
                 synthesizer: Optional[GtSynthesizer] = None):
        """`synthesizer` (a new one on the card by default) synthesises the
        meshes that the table's GT joints are regressed from."""
        rng = np.random.default_rng(seed)
        pose, shape = _smpl_draws(rng, n)
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
