"""Dataset base machinery (counterpart of gator_tpu/data/base.py): a
structure-of-arrays annotation table, and the batch assembly every
SMPL-fitted dataset shares. A batch slices the table, synthesises the GT
meshes of all its rows in one device program per gender (`gt_synth`), and
does the cheap per-sample 2D work on the host.

Ported: `SmplTable`, `SmplPoseDataset.make_batch` (the gender-grouped
synthesis) and `_assemble`, the batch forms of the in-step input paths
(`make_raw_batch`, `make_index_batch`, `packed_rows`,
`make_packed_batch`), `input_pose2d` (GT input, test-time detections, and
the two detector-noise simulators of training), `assemble_batch`,
`mixed_epoch_indices`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..assets.bundle import GatorAssets
from ..assets.skeletons import JointSet
from . import noise as noise_mod
from . import processing
from .augment import augm_params_batch
from .gt_synth import GtSynthesizer

GENDERS = ("neutral", "female", "male")


@dataclasses.dataclass
class SmplTable:
    """SoA annotations for datasets with SMPL fits + full cameras."""

    pose: np.ndarray            # [N, 72]
    shape: np.ndarray           # [N, 10]
    trans: np.ndarray           # [N, 3]
    cam_r: np.ndarray           # [N, 3, 3]
    cam_t: np.ndarray           # [N, 3] (mm)
    focal: np.ndarray           # [N, 2]
    princpt: np.ndarray         # [N, 2]
    joint_cam_h36m: np.ndarray  # [N, 17, 3] dataset GT (mm, camera space)
    joint_img_h36m: np.ndarray  # [N, 17, 2]
    gender: np.ndarray          # [N] int: 0 neutral / 1 female / 2 male
    meta: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def __len__(self):
        return self.pose.shape[0]


class SmplPoseDataset:
    """Common behaviour of H36M/MuCo-style datasets (SMPL parameters and
    full camera annotations); subclasses fill the table."""

    name = "base"

    def __init__(self, assets: GatorAssets, opts: processing.ProcessOptions,
                 table: SmplTable,
                 detected_pose: Optional[np.ndarray] = None):
        self.assets = assets
        self.opts = opts
        self.table = table
        self.joint_set: JointSet = assets.joint_set
        self.detected_pose = detected_pose  # [N, J, 2+] test-time detections
        self._h36m_stats = noise_mod.h36m_error_stats(
            ("Pelvis", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee",
             "L_Ankle", "Torso", "Neck", "Nose", "Head", "L_Shoulder",
             "L_Elbow", "L_Wrist", "R_Shoulder", "R_Elbow", "R_Wrist"))

    def __len__(self):
        return len(self.table)

    def make_batch(self, indices: np.ndarray, synth: GtSynthesizer,
                   rng: np.random.Generator,
                   stage: str = "gator") -> Dict[str, object]:
        """One batch of rows `indices`. The GT synthesis runs on the
        synthesizer's device, grouped by gender; the [B, V, 3] mesh stays
        there (root-relative, metres). COCO input needs the small per-joint
        arrays on the host (its 2D input derives from the fitted mesh);
        otherwise the fit gate stays on the device as a [B, 1, 1] mask and
        the batch needs no device-to-host copy."""
        t = self.table
        idx = np.asarray(indices)
        want_coco = self.opts.input_joint_name == "coco"
        if not want_coco and stage == "gat":
            # non-COCO GAT batches carry no mesh and no fit gate
            return self._assemble(
                idx, np.zeros((len(idx), 0, 3), np.float32), None, None,
                None, rng, stage)
        groups = []
        coco_cam = np.empty((len(idx), 19, 3), np.float32)
        coco_img = np.empty((len(idx), 19, 3), np.float32)
        fit_err = np.empty((len(idx),), np.float32)
        for g_code, g_name in enumerate(GENDERS):
            sel = np.nonzero(t.gender[idx] == g_code)[0]
            if len(sel) == 0:
                continue
            sub = idx[sel]
            root = t.joint_cam_h36m[sub][:, :1]
            out = synth.synthesize(
                t.pose[sub], t.shape[sub], t.trans[sub], t.cam_r[sub],
                t.cam_t[sub], t.focal[sub], t.princpt[sub],
                joint_cam_h36m=t.joint_cam_h36m[sub] - root,
                gender=g_name, want_coco=want_coco, host_fetch=want_coco)
            mesh_part = synth.mesh_rel_m(out["mesh_mm"], root)
            if want_coco:
                groups.append((sel, mesh_part, None))
                coco_cam[sel] = out["joint_cam_coco"]
                coco_img[sel] = out["joint_img_coco"]
                fit_err[sel] = out["fitting_error"]
            else:
                groups.append((sel, mesh_part, synth.fit_valid_mask(
                    out["fitting_error"], self.opts.fitting_thr)))

        if len(groups) == 1:
            _, mesh_rel_m, valid_dev = groups[0]
        else:
            dev = synth.device
            mesh_rel_m = torch.zeros((len(idx), self.assets.mean_vertices
                                      .shape[0], 3), device=dev)
            valid_dev = (None if want_coco
                         else torch.zeros((len(idx), 1, 1), device=dev))
            for sel, part, mask in groups:
                pos = torch.as_tensor(sel, device=dev)
                mesh_rel_m[pos] = part
                if mask is not None:
                    valid_dev[pos] = mask

        return self._assemble(idx, mesh_rel_m, coco_cam, coco_img,
                              fit_err if want_coco else None, rng, stage,
                              mesh_valid_dev=valid_dev)

    @property
    def supports_raw_batches(self) -> bool:
        """True when this dataset uses the shared make_batch path, so a raw
        (pre-synthesis) or index batch can feed the in-step paths. Readers
        with make_batch flows of their own (COCO, MuCo, AMASS, PW3D) have
        no such property at all."""
        return type(self).make_batch is SmplPoseDataset.make_batch

    def make_raw_batch(self, indices: np.ndarray, rng: np.random.Generator,
                       stage: str = "gator") -> Dict[str, np.ndarray]:
        """Host-only batch for in-step GT synthesis
        (`train.loop.with_gt_synthesis`): the raw SMPL and camera
        parameters (~100 floats a sample) in place of the [B, V, 3] mesh,
        which the step synthesises with its fit mask. The rng draws are
        make_batch's, in its order. Needs non-COCO input (COCO derives its
        2D input from the fitted mesh) and neutral-gender rows (one SMPL
        parameter set per step)."""
        t = self.table
        idx = np.asarray(indices)
        if self.opts.input_joint_name == "coco":
            raise ValueError("make_raw_batch: COCO-input batches derive "
                             "their 2D input from the fitted mesh and "
                             "cannot defer synthesis")
        if stage != "gator":
            # GAT batches need no mesh: make_batch already skips synthesis
            return self.make_batch(idx, None, rng, stage=stage)
        if (t.gender[idx] != 0).any():       # GENDERS[0] == "neutral"
            raise ValueError("make_raw_batch requires neutral-gender rows")
        batch = self._assemble(
            idx, np.zeros((len(idx), 0, 3), np.float32), None, None, None,
            rng, stage)
        # made in the step: mesh and mesh_valid by the synthesis; lift and
        # reg masks are ones on this path (bad_zero_gator=("mesh",)); the
        # fit-gate target is reg_pose3d (the root-relative h36m joints)
        del batch["mesh"], batch["mesh_valid"]
        del batch["lift_valid"], batch["reg_valid"]
        root = t.joint_cam_h36m[idx][:, :1]
        batch.update({
            "smpl_pose": t.pose[idx].astype(np.float32),
            "smpl_shape": t.shape[idx].astype(np.float32),
            "smpl_trans": t.trans[idx].astype(np.float32),
            "cam_r": t.cam_r[idx].astype(np.float32),
            "cam_t": t.cam_t[idx].astype(np.float32),
            "mesh_root_mm": root.astype(np.float32),
        })
        return batch

    def packed_rows(self, synth: GtSynthesizer, indices: np.ndarray):
        """The rows of the packed table (data/packed.py): the
        camera-rotated SMPL path grouped by gender."""
        from .packed import smpl_pose_packed_rows
        return smpl_pose_packed_rows(self, synth, indices)

    def make_packed_batch(self, indices: np.ndarray,
                          rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Host batch of the packed pipeline: (row, flips, rots) and the
        assembled 2D input. Needs `build_packed_tables` to have attached
        this dataset's PackedView."""
        from .packed import make_packed_batch
        return make_packed_batch(self, indices, rng)

    def make_index_batch(self, indices: np.ndarray,
                         rng: np.random.Generator,
                         stage: str = "gator") -> Dict[str, np.ndarray]:
        """Index-only batch of the device input pipeline
        (`data.device_pipeline`): (row indices, flip flags, rotation
        angles), from the same `augm_params_batch` draws as the host path.
        Stage-independent."""
        idx = np.asarray(indices)
        flips, rots = augm_params_batch(
            self.opts.is_train, self.opts.flip_enabled,
            self.opts.rotate_factor, len(idx), rng)
        return {"idx": idx.astype(np.int32),
                "flips": flips.astype(np.float32),
                "rots": rots.astype(np.float32)}

    def _assemble(self, idx, mesh_rel_m, coco_cam, coco_img, fit_err, rng,
                  stage, mesh_valid_dev=None) -> Dict[str, object]:
        t = self.table
        jc_h36m = t.joint_cam_h36m[idx]
        jh = jc_h36m - jc_h36m[:, :1]
        is_coco = self.opts.input_joint_name == "coco"
        if is_coco:
            joint_img_b, joint_cam_b = (coco_img[:, :, :2],
                                        coco_cam - coco_cam[:, -2:-1])
        else:
            joint_img_b, joint_cam_b = t.joint_img_h36m[idx], jh
        return assemble_batch(
            self.opts, self.joint_set, rng, stage,
            mesh_rel_m=mesh_rel_m, joint_img_b=joint_img_b,
            joint_cam_b=joint_cam_b, reg_pose=jh, fit_err=fit_err,
            detected_pose=(self.detected_pose[idx]
                           if self.detected_pose is not None else None),
            h36m_stats=self._h36m_stats,
            bad_zero_gator=("mesh", "lift") if is_coco else ("mesh",),
            bad_zero_gat=is_coco, mesh_valid_dev=mesh_valid_dev)


def input_pose2d(
    opts: processing.ProcessOptions,
    jset: JointSet,
    rng: np.random.Generator,
    joint_img_b: np.ndarray,                      # [B, J, 2]
    flips: np.ndarray, rots: np.ndarray,          # [B]
    detected_pose: Optional[np.ndarray] = None,   # [B, J, 2+] test dets
    h36m_stats: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The 2D-input half of `assemble_batch`: detector replacement (test),
    Human3.6M Gaussian detector noise or the COCO keypoint-noise simulator
    (detector-input training), then the batched crop/flip/normalise
    (reference per-sample forms: Human36M/dataset.py:364-389,421-453).
    The h36m noise is drawn once per sample, in order, before the crop, as
    the JAX package draws it, so one generator gives both the same input."""
    noise = None
    coco_noise = None
    dets = None
    b = len(joint_img_b)
    if not opts.use_gt_input and not opts.is_train \
            and detected_pose is not None:
        dets = detected_pose
    if not opts.use_gt_input and opts.is_train \
            and opts.input_joint_name == "human36" \
            and h36m_stats is not None:
        noise = np.stack([
            noise_mod.generate_h36m_syn_error(h36m_stats, rng)
            for _ in range(b)])
        noise = noise / 256.0 * np.array(
            [opts.input_shape[1], opts.input_shape[0]], np.float32)
    if not opts.use_gt_input and opts.is_train \
            and opts.input_joint_name == "coco":
        coco_noise = {
            "areas": processing.crop_area_batch(joint_img_b, opts),
            "rng": rng}
    return processing.batch_crop_and_normalize(
        joint_img_b.astype(np.float32), jset, opts, flips, rots,
        h36m_noise=noise, coco_noise=coco_noise, detected_pose=dets)


def assemble_batch(
    opts: processing.ProcessOptions,
    jset: JointSet,
    rng: np.random.Generator,
    stage: str,
    *,
    mesh_rel_m,                  # [B, V, 3] root-relative mesh, metres;
                                 # a device tensor after synthesis
    joint_img_b: np.ndarray,     # [B, J, 2] input pixel joints
    joint_cam_b: np.ndarray,     # [B, J, 3] root-relative lift target, mm
    reg_pose: np.ndarray,        # [B, 17, 3] root-relative h36m target, mm
    fit_err: Optional[np.ndarray] = None,     # [B] or None (all good)
    detected_pose: Optional[np.ndarray] = None,   # [B, J, 2+] test dets
    h36m_stats: Optional[np.ndarray] = None,
    bad_zero_gator=("mesh",),    # masks zeroed on a bad fit (gator stage)
    bad_zero_gat: bool = False,  # zero joint_valid on a bad fit (gat stage)
    mesh_valid_dev=None,         # [B, 1, 1] device fit mask replacing the
                                 # host fit_err path; only valid when the
                                 # mesh is the sole fit-gated target
) -> Dict[str, object]:
    """Vectorised batch assembly shared by every dataset (the reference
    runs it per sample in DataLoader workers —
    Human36M/dataset.py:339-419)."""
    b = len(joint_img_b)
    flips, rots = augm_params_batch(
        opts.is_train, opts.flip_enabled, opts.rotate_factor, b, rng)
    pose2d = input_pose2d(opts, jset, rng, joint_img_b, flips, rots,
                          detected_pose=detected_pose,
                          h36m_stats=h36m_stats)

    def batch_j3d(s):
        """In-plane rotation and flip of 3D joints (augment.j3d_processing
        math, batched)."""
        rad = -rots * np.pi / 180.0
        cs, sn = np.cos(rad), np.sin(rad)
        x = cs[:, None] * s[..., 0] - sn[:, None] * s[..., 1]
        y = sn[:, None] * s[..., 0] + cs[:, None] * s[..., 1]
        out = np.stack([x, y, s[..., 2]], axis=-1)
        if flips.any():
            fl = out.copy()
            pairs = np.asarray(jset.flip_pairs)
            if len(pairs):
                tmp = fl[:, pairs[:, 0]].copy()
                fl[:, pairs[:, 0]] = fl[:, pairs[:, 1]]
                fl[:, pairs[:, 1]] = tmp
            fl[..., 0] = -fl[..., 0]
            out = np.where(flips[:, None, None].astype(bool), fl, out)
        return out.astype(np.float32)

    if mesh_valid_dev is not None and (
            fit_err is not None or tuple(bad_zero_gator) != ("mesh",)
            or bad_zero_gat):
        raise ValueError("mesh_valid_dev only supports mesh-only fit gating")
    bad = (fit_err > opts.fitting_thr if fit_err is not None
           else np.zeros(b, bool))
    if stage == "gator":
        good = (mesh_valid_dev if mesh_valid_dev is not None
                else (~bad).astype(np.float32)[:, None, None])
        ones = np.ones((b, 1, 1), np.float32)
        return {
            "pose2d": pose2d,
            "mesh": mesh_rel_m,
            "lift_pose3d": batch_j3d(joint_cam_b),
            "reg_pose3d": reg_pose.astype(np.float32),
            "mesh_valid": good if "mesh" in bad_zero_gator else ones,
            "reg_valid": good if "reg" in bad_zero_gator else ones,
            "lift_valid": good if "lift" in bad_zero_gator else ones,
        }
    joint_valid = np.ones((b, 1, 1), np.float32)
    if bad_zero_gat:
        joint_valid[bad] = 0
    return {
        "pose2d": pose2d,
        "joint_cam": batch_j3d(joint_cam_b),
        "joint_valid": joint_valid,
    }


def mixed_epoch_indices(lengths, rng: np.random.Generator) -> np.ndarray:
    """MultipleDatasets(make_same_len=True) semantics: epoch length =
    max_len * n_dbs; each slot draws a uniform random dataset; data index =
    (slot % max_len) % len(db), except in the modular tail (slots beyond
    len(db) * (max_len // len(db))), which resamples uniformly
    (reference: data/multiple_datasets.py:22-29). -> [N, 2] (db, index)."""
    lengths = np.asarray(lengths, np.int64)
    n_dbs = len(lengths)
    max_len = int(lengths.max())
    total = max_len * n_dbs
    db_choice = rng.integers(0, n_dbs, size=total)
    slot = np.arange(total, dtype=np.int64) % max_len
    db_len = lengths[db_choice]
    cutoff = db_len * (max_len // db_len)
    resampled = rng.integers(0, db_len)
    data_idx = np.where(slot >= cutoff, resampled, slot % db_len)
    return np.stack([db_choice, data_idx], axis=1)
