"""Ground-truth synthesis on the device (counterpart of
gator_tpu/data/gt_synth.py): camera-rotation compensation of the root pose,
the SMPL forward, translation compensation, joint regression and the COCO
pelvis/neck, batched over a whole batch (the reference runs SMPL per sample
on the CPU: Human36M/dataset.py:254-309).

The `*_fn` functions take their tables as arguments; `GtSynthesizer` binds
them to one asset bundle's tables on one device. Every product runs in true
f32 (TF32 off): these are evaluation targets and fit-validity decisions.
The [B, V, 3] mesh stays on the device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..assets.bundle import GatorAssets
from ..bodymodel.rotations import axis_angle_to_rotmat, rotmat_to_axis_angle
from ..bodymodel.smpl import SmplParams, smpl_forward
from ..precision import no_tf32


def rotate_root_pose(pose: torch.Tensor, cam_r: torch.Tensor) -> torch.Tensor:
    """aa_root' = log(R_cam @ exp(aa_root)) (reference:
    Human36M/dataset.py:268-274)."""
    rot = axis_angle_to_rotmat(pose[:, :3])
    new_root = rotmat_to_axis_angle(
        (cam_r[:, :, :, None] * rot[:, None, :, :]).sum(-2))
    return torch.cat([new_root, pose[:, 3:]], dim=1)


def prep_shape_fn(shape: torch.Tensor, mean_b: torch.Tensor,
                  clean: bool = True) -> torch.Tensor:
    """With `clean`, zero beta rows with any |b| > 3 (fit failures,
    reference: Human36M/dataset.py:265); then an all-zero row takes the
    model's mean betas (smpl_layer.py:87-95)."""
    if clean:
        bad = (shape.abs() > 3).any(dim=1, keepdim=True)
        shape = torch.where(bad, torch.zeros_like(shape), shape)
    zero = (shape == 0).all(dim=1, keepdim=True)
    return torch.where(zero, mean_b[None], shape)


def mesh_cam_fn(params: SmplParams, mean_b, pose, shape, trans, cam_r,
                cam_t):
    """Batched get_smpl_coord: (mesh_mm [B, V, 3], smpl_joints_mm
    [B, 24, 3]) in camera space, millimetres (reference:
    Human36M/dataset.py:254-300)."""
    pose_eff = rotate_root_pose(pose, cam_r)
    shape_eff = prep_shape_fn(shape, mean_b)
    verts, joints = smpl_forward(params, pose_eff, shape_eff)
    # translation compensation: the root rotation was about the origin,
    # not the root joint (reference: dataset.py:287-295)
    smpl_trans = (cam_r * trans[:, None, :]).sum(-1) + cam_t / 1000.0
    root = joints[:, :1]                                 # [B, 1, 3]
    smpl_trans = (smpl_trans[:, None] - root
                  + (cam_r[:, None] * root[:, :, None, :]).sum(-1))
    return (verts + smpl_trans) * 1000.0, (joints + smpl_trans) * 1000.0


def mesh_direct_fn(params: SmplParams, mean_b, pose, shape, trans,
                   clean: bool):
    """SMPL with the translation applied inside the layer and no camera
    rotation: the MuCo and 3DPW path (reference: MuCo/dataset.py:196-216
    with |beta| > 3 cleaning, PW3D/dataset.py:84-102 without)."""
    verts, joints = smpl_forward(params, pose,
                                 prep_shape_fn(shape, mean_b, clean), trans)
    return verts * 1000.0, joints * 1000.0


def mesh_plain_fn(params: SmplParams, mean_b, pose, shape, clean: bool):
    """SMPL with neither translation nor camera rotation: the COCO
    SMPLify-fit path (reference: COCO/dataset.py:147-166)."""
    verts, joints = smpl_forward(params, pose,
                                 prep_shape_fn(shape, mean_b, clean))
    return verts * 1000.0, joints * 1000.0


def mesh_rotated_fn(params: SmplParams, mean_b, pose, shape, cam_r,
                    cam_t_m, clean: bool):
    """Camera-rotated root pose plus an additive translation in metres: the
    AMASS virtual-camera path (reference: AMASS/dataset.py:186-213)."""
    verts, joints = smpl_forward(params, rotate_root_pose(pose, cam_r),
                                 prep_shape_fn(shape, mean_b, clean))
    return ((verts + cam_t_m[:, None]) * 1000.0,
            (joints + cam_t_m[:, None]) * 1000.0)


_LHIP, _RHIP = 11, 12       # coco joint indices
_LSHO, _RSHO = 5, 6


def _coco_cam_joints(j_reg_coco, mesh_mm):
    cam = torch.einsum("jv,bvc->bjc", j_reg_coco, mesh_mm)
    pelvis = 0.5 * (cam[:, _LHIP] + cam[:, _RHIP])
    neck = 0.5 * (cam[:, _LSHO] + cam[:, _RSHO])
    return torch.cat([cam, pelvis[:, None], neck[:, None]], dim=1)


def coco_weak_perspective_fn(j_reg_coco, mesh_mm, s, t):
    """COCO joints from the mesh with a weak-perspective projection
    img = (cam_xy / 1000) * s + t (reference: COCO/dataset.py:183-194)."""
    cam = _coco_cam_joints(j_reg_coco, mesh_mm)
    xy = cam[..., :2] / 1000.0 * s[:, None] + t[:, None]
    return cam, torch.cat([xy, torch.ones_like(cam[..., :1])], dim=-1)


def coco_from_mesh_fn(j_reg_coco, mesh_mm, focal, princpt):
    """COCO joints regressed from the mesh, plus pelvis and neck, in camera
    and pixel coordinates (reference: Human36M/dataset.py:311-334)."""
    cam = _coco_cam_joints(j_reg_coco, mesh_mm)
    xy = cam[..., :2] / cam[..., 2:3] * focal[:, None] + princpt[:, None]
    return cam, torch.cat([xy, torch.ones_like(cam[..., :1])], dim=-1)


def h36m_from_mesh_fn(j_reg_h36m, mesh_mm):
    return torch.einsum("jv,bvc->bjc", j_reg_h36m, mesh_mm)


def mesh_rel_m_fn(mesh_mm, root_mm):
    """Root-relative mesh in metres, the target (reference:
    Human36M/dataset.py:352-356, then /1000 in __getitem__)."""
    return ((mesh_mm - root_mm) / 1000.0).float()


def fitting_error_fn(j_reg_h36m, joint_cam_h36m, mesh_mm):
    """Translation-aligned joint error of the fitted mesh against the
    dataset GT (reference: Human36M/dataset.py:302-309): root-relative GT
    in, error in mm out [B]."""
    gt = joint_cam_h36m - joint_cam_h36m[:, :1]
    reg = h36m_from_mesh_fn(j_reg_h36m, mesh_mm)
    reg = reg - reg.mean(dim=1, keepdim=True) + gt.mean(dim=1, keepdim=True)
    return torch.sqrt(((gt - reg) ** 2).sum(-1)).mean(-1)


def fit_valid_mask_fn(fitting_error, thr: float):
    """[B, 1, 1] f32 mask: 1 where the fitted mesh is within `thr` mm of the
    dataset GT joints (reference: Human36M/dataset.py:396-401)."""
    return (fitting_error <= thr).float()[:, None, None]


class GtSynthesizer:
    """GT mesh/joint synthesis bound to one asset bundle's tables (SMPL per
    gender, joint regressors, mean betas) on one device. Host numpy arrays
    passed in are copied to that device; results stay there unless a
    method says otherwise."""

    def __init__(self, assets: GatorAssets, device="cuda"):
        self.assets = assets
        self.device = torch.device(device)
        self.params = {g: SmplParams.from_model(m, self.device)
                       for g, m in assets.smpl_gendered.items()}
        self.mean_betas = {g: self._t(m.mean_betas)
                           for g, m in assets.smpl_gendered.items()}
        self.j_reg_h36m = self._t(assets.j_regressor_h36m)
        self.j_reg_coco = self._t(assets.j_regressor_coco)

    def _t(self, a) -> torch.Tensor:
        """A host array (or a tensor) as f32 on this synthesizer's device."""
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def smpl_mesh_cam(self, pose, shape, trans, cam_r, cam_t,
                      gender: str = "neutral"):
        no_tf32()
        return mesh_cam_fn(self.params[gender], self.mean_betas[gender],
                           *map(self._t, (pose, shape, trans, cam_r, cam_t)))

    def smpl_mesh_direct(self, pose, shape, trans, gender: str = "neutral",
                         clean: bool = True):
        no_tf32()
        return mesh_direct_fn(self.params[gender], self.mean_betas[gender],
                              *map(self._t, (pose, shape, trans)), clean)

    def smpl_mesh_plain(self, pose, shape, gender: str = "neutral",
                        clean: bool = True):
        no_tf32()
        return mesh_plain_fn(self.params[gender], self.mean_betas[gender],
                             *map(self._t, (pose, shape)), clean)

    def smpl_mesh_rotated(self, pose, shape, cam_r, cam_t_m,
                          gender: str = "neutral", clean: bool = False):
        no_tf32()
        return mesh_rotated_fn(self.params[gender], self.mean_betas[gender],
                               *map(self._t, (pose, shape, cam_r, cam_t_m)),
                               clean)

    def coco_weak_perspective(self, mesh_mm, s, t):
        return coco_weak_perspective_fn(self.j_reg_coco, mesh_mm,
                                        self._t(s), self._t(t))

    def coco_from_mesh(self, mesh_mm, focal, princpt):
        return coco_from_mesh_fn(self.j_reg_coco, mesh_mm, self._t(focal),
                                 self._t(princpt))

    def h36m_from_mesh(self, mesh_mm):
        return h36m_from_mesh_fn(self.j_reg_h36m, mesh_mm)

    def mesh_rel_m(self, mesh_mm, root_mm):
        return mesh_rel_m_fn(mesh_mm, self._t(root_mm))

    def fitting_error(self, joint_cam_h36m, mesh_mm):
        return fitting_error_fn(self.j_reg_h36m, self._t(joint_cam_h36m),
                                mesh_mm)

    def fit_valid_mask(self, fitting_error, thr: float):
        return fit_valid_mask_fn(fitting_error, thr)

    def synthesize(self, pose: np.ndarray, shape: np.ndarray,
                   trans: np.ndarray, cam_r: np.ndarray, cam_t: np.ndarray,
                   focal: np.ndarray, princpt: np.ndarray,
                   joint_cam_h36m: Optional[np.ndarray] = None,
                   gender: str = "neutral", want_coco: bool = True,
                   host_fetch: bool = True) -> Dict[str, object]:
        """The GT bundle of a batch. want_coco=False skips the COCO joint
        regression; host_fetch=True copies the small per-joint arrays to
        host numpy (one copy each), False leaves them on the device. The
        [B, V, 3] mesh always stays on the device."""
        mesh_mm, smpl_joints_mm = self.smpl_mesh_cam(
            pose, shape, trans, cam_r, cam_t, gender)
        small = {"smpl_joints_mm": smpl_joints_mm}
        if want_coco:
            coco_cam, coco_img = self.coco_from_mesh(mesh_mm, focal, princpt)
            small["joint_cam_coco"] = coco_cam
            small["joint_img_coco"] = coco_img
        if joint_cam_h36m is not None:
            small["fitting_error"] = self.fitting_error(joint_cam_h36m,
                                                        mesh_mm)
        out = ({k: v.cpu().numpy() for k, v in small.items()} if host_fetch
               else small)
        out["mesh_mm"] = mesh_mm
        return out
