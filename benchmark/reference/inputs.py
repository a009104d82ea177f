"""The training step's inputs and targets, worked out again from the raw
dataset tables (the counterparts of the annotation files): each dataset's
own SMPL path and fit gate, the crop, the detector noise, the flip and the
standardisation, the augmented lift target (reference: kasvii/GATOR
Human36M, COCO and MuCo dataset.py and lib/noise_utils.py).

`assemble(kind, ...)` takes what the program's pipeline fed a step (row
indices, flips, rotations) and returns the batch the model step sees, in
the program's keys, so that the two can be compared and the reference's
step run on its own.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import noise
from .masks import step_seed
from .smpl import (coco_camera_joints, fitting_error_3d, mesh_camera,
                   prep_shape, project)

NOISE_SALT = 0x6E6F69          # keys the noise stream apart from dropout
FIT_THR = {"Human36M": 25.0, "Synthetic": 25.0, "COCO": 3.0, "MuCo": 45.0}
MUCO_JOINTS = (
    "Head_top", "Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "L_Shoulder",
    "L_Elbow", "L_Wrist", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee",
    "L_Ankle", "Pelvis", "Spine", "Head", "R_Hand", "L_Hand", "R_Toe",
    "L_Toe")
H36M_JOINTS = (
    "Pelvis", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee", "L_Ankle",
    "Torso", "Neck", "Nose", "Head", "L_Shoulder", "L_Elbow", "L_Wrist",
    "R_Shoulder", "R_Elbow", "R_Wrist")


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _gates(bad: torch.Tensor, zero: Sequence[str]) -> Dict[str, torch.Tensor]:
    good = (~bad).float()
    one = torch.ones_like(good)
    return {k + "_valid": (good if k in zero else one)
            for k in ("mesh", "reg", "lift")}


def smpl_table_rows(tb, table, idx, coco_input: bool, thr: float):
    """Human3.6M's path (dataset.py:254-300,339-419) on an SmplTable."""
    dev = tb["j_h36m"].device
    t = lambda a: _t(np.asarray(a)[idx], dev)               # noqa: E731
    mesh_mm = mesh_camera(tb["smpl"], t(table.pose), t(table.shape),
                          t(table.trans), t(table.cam_r), t(table.cam_t))
    jc = t(table.joint_cam_h36m)
    jh = jc - jc[:, :1]
    bad = fitting_error_3d(tb["j_h36m"], jc, mesh_mm) > thr
    if coco_input:
        cam = coco_camera_joints(tb["j_coco"], mesh_mm)
        img = project(cam, t(table.focal), t(table.princpt))
        cam_in = cam - cam[:, -2:-1]
    else:
        img, cam_in = t(table.joint_img_h36m)[..., :2], jh
    return {"mesh": (mesh_mm - jc[:, :1]) / 1000.0, "reg": jh,
            "cam_in": cam_in, "img_in": img,
            **_gates(bad, ("mesh", "lift") if coco_input else ("mesh",))}


def coco_rows(tb, table, idx, thr: float):
    """COCO's SMPLify path (dataset.py:147-214): no camera rotation, a
    weak-perspective projection, the 2D fit gate in a 64x64 crop."""
    dev = tb["j_h36m"].device
    t = lambda a: _t(np.asarray(a)[idx], dev)               # noqa: E731
    smpl = tb["smpl"]
    verts, _ = smpl.forward(t(table.pose),
                            prep_shape(t(table.shape), smpl.mean_betas))
    mesh_mm = verts * 1000.0
    cam = coco_camera_joints(tb["j_coco"], mesh_mm)
    img = cam[..., :2] / 1000.0 * t(table.cam_s)[:, None] \
        + t(table.cam_t)[:, None]
    h36m = torch.einsum("jv,bvc->bjc", tb["j_h36m"], mesh_mm)
    bbox = t(table.bbox)
    wsq = torch.maximum(bbox[:, 2] - 1.0, bbox[:, 3] - 1.0)
    ok = (bbox[:, 2] * bbox[:, 3] > 0) & (bbox[:, 2] >= 1) \
        & (bbox[:, 3] >= 1)
    kp_valid = t(table.joint_valid)[..., 0] == 1
    d = torch.linalg.vector_norm(t(table.joint_img)[..., :2] - img[:, :17],
                                 dim=-1)
    cnt = kp_valid.sum(-1)
    mean_d = (d * kp_valid).sum(-1) / torch.clamp(cnt, min=1)
    fit = torch.where(ok & (cnt > 0),
                      64.0 / torch.clamp(wsq, min=1e-9) * mean_d,
                      torch.full_like(mean_d, float("inf")))
    return {"mesh": (mesh_mm - h36m[:, :1]) / 1000.0,
            "reg": h36m - h36m[:, :1], "cam_in": cam - cam[:, -2:-1],
            "img_in": img, **_gates(fit > thr, ("mesh", "reg", "lift"))}


def muco_rows(tb, table, idx, thr: float):
    """MuCo's path (dataset.py:196-262): SMPL with its translation, full
    cameras, the 3D fit gate on the joints MuCo shares with Human3.6M."""
    dev = tb["j_h36m"].device
    t = lambda a: _t(np.asarray(a)[idx], dev)               # noqa: E731
    smpl = tb["smpl"]
    verts, _ = smpl.forward(t(table.pose),
                            prep_shape(t(table.shape), smpl.mean_betas),
                            t(table.trans))
    mesh_mm = verts * 1000.0
    cam = coco_camera_joints(tb["j_coco"], mesh_mm)
    img = project(cam, t(table.focal), t(table.princpt))
    h36m = torch.einsum("jv,bvc->bjc", tb["j_h36m"], mesh_mm)
    pairs = [(hi, MUCO_JOINTS.index(n)) for hi, n in enumerate(H36M_JOINTS)
             if n in MUCO_JOINTS]
    mu = t(table.joint_cam_muco)
    rel = mu - mu[:, MUCO_JOINTS.index("Pelvis")][:, None]
    gt = rel[:, [m for _, m in pairs]]
    reg = torch.einsum("jv,bvc->bjc", tb["j_h36m"][[h for h, _ in pairs]],
                       mesh_mm)
    reg = reg - reg.mean(1, keepdim=True) + gt.mean(1, keepdim=True)
    fit = torch.sqrt(((gt - reg) ** 2).sum(-1)).mean(-1)
    return {"mesh": (mesh_mm - h36m[:, :1]) / 1000.0,
            "reg": h36m - h36m[:, :1], "cam_in": cam - cam[:, -2:-1],
            "img_in": img, **_gates(fit > thr, ("mesh", "reg", "lift"))}


def crop_area(img: torch.Tensor, input_shape) -> torch.Tensor:
    """The tight bbox's area after the crop (the detector noise's OKS
    area; Human36M/dataset.py:424-431)."""
    tw = img[..., 0].amax(1) - img[..., 0].amin(1)
    th = img[..., 1].amax(1) - img[..., 1].amin(1)
    valid = (tw * th > 0) & (tw >= 1) & (th >= 1)
    aspect = input_shape[1] / input_shape[0]
    proc_w = torch.maximum(tw - 1.0, aspect * (th - 1.0))
    k = float(input_shape[1]) / torch.where(proc_w > 0, proc_w,
                                            torch.ones_like(proc_w))
    return torch.where(valid, tw * th * k * k, torch.ones_like(tw))


def affine_crop(img, input_shape, rots):
    """Tight bbox -> aspect snap -> rotation about the centre -> the
    input's pixel frame (processing's crop affine)."""
    res_h, res_w = int(input_shape[0]), int(input_shape[1])
    aspect = input_shape[1] / input_shape[0]
    x0, x1 = img[..., 0].amin(1), img[..., 0].amax(1)
    y0, y1 = img[..., 1].amin(1), img[..., 1].amax(1)
    w, h = x1 - x0, y1 - y0
    cx, cy = x0 + (w - 1) / 2.0, y0 + (h - 1) / 2.0
    bad = (w < 1.0) | (h < 1.0)
    w, h = w - 1.0, h - 1.0
    h = torch.where(w > aspect * h, w / aspect, h)
    w = torch.where(w < aspect * h, h * aspect, w)
    w = torch.where(bad, torch.ones_like(w), w)
    cx = torch.where(bad, torch.full_like(cx, 0.5), cx)
    cy = torch.where(bad, torch.full_like(cy, 0.5), cy)
    rad = math.pi * rots / 180.0
    cs, sn = torch.cos(rad)[:, None], torch.sin(rad)[:, None]
    k = (res_w / w)[:, None]
    rx, ry = img[..., 0] - cx[:, None], img[..., 1] - cy[:, None]
    return torch.stack([(cs * rx + sn * ry) * k + res_w / 2.0,
                        (-sn * rx + cs * ry) * k + res_h / 2.0], -1)


def flip_perm(num_joint: int, pairs) -> List[int]:
    perm = list(range(num_joint))
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def flip_standardize(x, perm, input_shape, flips):
    res_h, res_w = float(input_shape[0]), float(input_shape[1])
    fl = x[:, perm]
    fl = torch.stack([res_w - fl[..., 0] - 1, fl[..., 1]], -1)
    x = torch.where((flips > 0)[:, None, None], fl, x)
    x = torch.stack([x[..., 0] / res_w, x[..., 1] / res_h], -1)
    x = x - x.mean(1, keepdim=True)
    return x / torch.sqrt((x * x).mean(1, keepdim=True))


def augment_3d(s, perm, flips, rots):
    """Rotate about z by -rot, then the flip: pairs swapped, x negated."""
    rad = -rots * math.pi / 180.0
    cs, sn = torch.cos(rad)[:, None], torch.sin(rad)[:, None]
    out = torch.stack([cs * s[..., 0] - sn * s[..., 1],
                       sn * s[..., 0] + cs * s[..., 1], s[..., 2]], -1)
    fl = out[:, perm]
    fl = torch.stack([-fl[..., 0], fl[..., 1], fl[..., 2]], -1)
    return torch.where((flips > 0)[:, None, None], fl, out)


class Rows:
    """The per-row inputs and targets of the rows a few steps read, keyed
    by their global row number (datasets concatenated in the recipe's
    order)."""

    def __init__(self, tb, datasets: Sequence, names: Sequence[str],
                 rows: torch.Tensor, coco_input: bool, input_shape):
        dev = tb["j_h36m"].device
        rows = rows.long().cpu().numpy()
        self.index = {}
        parts, offset, pos = [], 0, 0
        for ds, name in zip(datasets, names):
            n = len(ds.table.pose)
            sel = np.unique(rows[(rows >= offset) & (rows < offset + n)])
            if len(sel):
                local = sel - offset
                thr = FIT_THR[name]
                if name == "COCO":
                    part = coco_rows(tb, ds.table, local, thr)
                elif name == "MuCo":
                    part = muco_rows(tb, ds.table, local, thr)
                else:
                    part = smpl_table_rows(tb, ds.table, local, coco_input,
                                           thr)
                part["area"] = crop_area(part["img_in"], input_shape)
                parts.append(part)
                for r in sel:
                    self.index[int(r)] = pos
                    pos += 1
            offset += n
        self.cols = {k: torch.cat([p[k] for p in parts])
                     for k in parts[0]}
        self.device = dev

    def take(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        at = torch.as_tensor([self.index[int(r)] for r in rows.tolist()],
                             device=self.device)
        return {k: v[at] for k, v in self.cols.items()}


def assemble(rows: Rows, batch: Dict[str, torch.Tensor], seed: int,
             step: int, tb, input_shape, detector_noise: bool,
             given: Dict[str, np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """The batch the model step sees, from the pipeline's (row, flips,
    rots) batch: "row" (packed mixes) or "idx" (one table). `given`
    ({"img_in", "area"} by global row) replaces the reference's own input
    joints and crop areas: the detector noise's candidates flip at an
    acceptance radius when those move by f32 rounding, so the noise stage
    is followed from the program's table and the table is judged apart."""
    row = batch["row"] if "row" in batch else batch["idx"]
    flips = batch["flips"].to(rows.device).float()
    rots = batch["rots"].to(rows.device).float()
    r = rows.take(row)
    if given is not None:
        at = row.long().cpu().numpy()
        r.update({k: _t(v[at], rows.device) for k, v in given.items()})
    perm = flip_perm(tb["joint_num"], tb["flip_pairs"])
    x = affine_crop(r["img_in"], input_shape, rots)
    if detector_noise:
        gen = torch.Generator(device=rows.device)
        gen.manual_seed(step_seed(int(seed) ^ NOISE_SALT, step))
        x = torch.cat([noise.synthesize(noise.Draws(gen), x[:, :17],
                                        r["area"]), x[:, 17:]], 1)
    return {"pose2d": flip_standardize(x, perm, input_shape, flips),
            "mesh": r["mesh"], "reg_pose3d": r["reg"],
            "lift_pose3d": augment_3d(r["cam_in"], perm, flips, rots),
            **{k: r[k][:, None, None]
               for k in ("mesh_valid", "reg_valid", "lift_valid")}}
