"""The input pipeline on the device (counterpart of
gator_tpu/data/device_pipeline.py; TRAIN.gt_in_step="full").

The annotation table lives on the device, owned by the step wrapper; each
training batch carries only (row indices, flip flags, rotation angles),
~12 bytes a sample, and the wrapped step gathers the rows, builds and
augments the 2D input, synthesises the GT mesh (SMPL) and gates the losses
on the device. The functions are torch forms of the host batch assembly
(`processing.batch_crop_and_normalize`'s GT branch and
`base.assemble_batch`'s 3D-target augmentation; reference per sample:
Human36M/dataset.py:339-419).

Scope, checked when the wrapper is built: GT 2D input (detector input
rides the packed pipeline, data/packed.py) and a non-COCO joint set (the
COCO input derives from the fitted mesh). Gendered tables take one SMPL
forward per gender present and a per-row select.

A wrapped step keeps the inner step's signature, `step(state, batch, seed
[, edge_enabled])`, and carries its input assembly as `step.assemble(state,
batch, seed, ...)`, which returns the inner step's batch. The assembly
makes no host copy and no host sync when the batch's leaves are already
on the table's device (`data.BatchPipeline` puts index batches there).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from ..precision import no_tf32
from ..profiling import span
from .base import GENDERS
from .gt_synth import fit_valid_mask_fn, fitting_error_fn, mesh_cam_fn


def _flip_perm(num_joint: int, flip_pairs) -> np.ndarray:
    perm = np.arange(num_joint)
    for a, b in np.asarray(flip_pairs).reshape(-1, 2):
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def _perm_on(flip_perm, device) -> torch.Tensor:
    return torch.as_tensor(flip_perm, dtype=torch.long, device=device)


def affine_crop(joint_img: torch.Tensor, input_shape,
                rots: torch.Tensor) -> torch.Tensor:
    """Crop-space pixel joints: tight bbox -> aspect snap ->
    rotate-about-centre affine (the first half of
    processing.batch_crop_and_normalize, before noise, flip and
    normalisation)."""
    res_h, res_w = int(input_shape[0]), int(input_shape[1])
    aspect = input_shape[1] / input_shape[0]

    x0 = joint_img[..., 0].amin(1)
    x1 = joint_img[..., 0].amax(1)
    y0 = joint_img[..., 1].amin(1)
    y1 = joint_img[..., 1].amax(1)
    w = x1 - x0
    h = y1 - y0
    cx, cy = x0 + (w - 1) / 2.0, y0 + (h - 1) / 2.0
    bad = (w < 1.0) | (h < 1.0)
    w = w - 1.0
    h = h - 1.0
    h = torch.where(w > aspect * h, w / aspect, h)
    w = torch.where(w < aspect * h, h * aspect, w)
    w = torch.where(bad, 1.0, w)
    cx = torch.where(bad, 0.5, cx)
    cy = torch.where(bad, 0.5, cy)

    rad = math.pi * rots / 180.0
    cs, sn = torch.cos(rad), torch.sin(rad)
    k = res_w / w
    rel = joint_img - torch.stack([cx, cy], dim=1)[:, None, :]
    xr = cs[:, None] * rel[..., 0] + sn[:, None] * rel[..., 1]
    yr = -sn[:, None] * rel[..., 0] + cs[:, None] * rel[..., 1]
    return torch.stack([xr * k[:, None] + res_w / 2.0,
                        yr * k[:, None] + res_h / 2.0], dim=-1)


def flip_standardize(out: torch.Tensor, flip_perm, input_shape,
                     flips: torch.Tensor) -> torch.Tensor:
    """Flip + [0, 1] scaling + per-sample standardisation (the second half
    of processing.batch_crop_and_normalize, after optional noise).
    flip_perm: the joint permutation, an index array or a long tensor on
    the device."""
    res_h, res_w = int(input_shape[0]), int(input_shape[1])
    flipped = out[:, _perm_on(flip_perm, out.device)]
    flipped = torch.stack([res_w - flipped[..., 0] - 1, flipped[..., 1]],
                          dim=-1)
    out = torch.where((flips > 0)[:, None, None], flipped, out)
    out = torch.stack([out[..., 0] / float(res_w),
                       out[..., 1] / float(res_h)], dim=-1)
    mean = out.mean(dim=1, keepdim=True)
    centred = out - mean
    std = torch.sqrt((centred * centred).mean(dim=1, keepdim=True))
    return (centred / std).float()


def crop_normalize_gt(joint_img: torch.Tensor, flip_perm, input_shape,
                      flips: torch.Tensor, rots: torch.Tensor
                      ) -> torch.Tensor:
    """processing.batch_crop_and_normalize's GT-input branch: tight bbox
    -> aspect snap -> rotate-about-centre affine -> flip -> [0, 1] scaling
    -> per-sample standardisation."""
    return flip_standardize(affine_crop(joint_img, input_shape, rots),
                            flip_perm, input_shape, flips)


def j3d_augment(s: torch.Tensor, flip_perm, flips: torch.Tensor,
                rots: torch.Tensor) -> torch.Tensor:
    """assemble_batch's batch_j3d: rotate the 3D target about z by -rot,
    swap the flip pairs and negate x on flipped samples."""
    rad = -rots * math.pi / 180.0
    cs, sn = torch.cos(rad), torch.sin(rad)
    x = cs[:, None] * s[..., 0] - sn[:, None] * s[..., 1]
    y = sn[:, None] * s[..., 0] + cs[:, None] * s[..., 1]
    out = torch.stack([x, y, s[..., 2]], dim=-1)
    fl = out[:, _perm_on(flip_perm, out.device)]
    fl = torch.stack([-fl[..., 0], fl[..., 1], fl[..., 2]], dim=-1)
    return torch.where((flips > 0)[:, None, None], fl, out).float()


def leaves_on(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Every leaf of a batch as a tensor on `device`, dtype kept; a leaf
    already there is not copied."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def with_assembly(step_fn: Callable, assemble: Callable) -> Callable:
    """`step(state, batch, *extra) = step_fn(state, assemble(state, batch,
    *extra), *extra)`, with the assembly exposed as `step.assemble` and the
    wrapped step as `step.inner`. The assembly in the step is the span
    step.assemble, and the SMPL synthesis in it step.gt."""
    def step(state, batch, *extra):
        with span("step.assemble"):
            inner = assemble(state, batch, *extra)
        return step_fn(state, inner, *extra)

    step.assemble = assemble
    step.inner = step_fn
    return step


def _check_and_load_table(table, opts, need_smpl: bool, device):
    """The SmplTable's columns the step reads, as f32 tensors on `device`,
    and the genders present (a build-time set)."""
    if not opts.use_gt_input:
        raise ValueError("device input pipeline: detector-noise input "
                         "draws host-side rng; needs use_gt_input "
                         "(the packed pipeline covers detector input)")
    if opts.input_joint_name == "coco":
        raise ValueError("device input pipeline: the COCO 2D input "
                         "derives from the fitted mesh on host "
                         "(the packed pipeline covers it)")

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    tbl = {"joint_img": f32(np.asarray(table.joint_img_h36m)[..., :2]),
           "joint_cam": f32(table.joint_cam_h36m)}
    genders = ("neutral",)
    if need_smpl:
        for name in ("pose", "shape", "trans", "cam_r", "cam_t"):
            tbl[name] = f32(getattr(table, name))
        # one SMPL forward per gender present in the table, with a per-row
        # select (the host path groups by gender: base.make_batch)
        genders = tuple(g for code, g in enumerate(GENDERS)
                        if (np.asarray(table.gender) == code).any()) \
            or ("neutral",)
        if len(genders) > 1:
            tbl["gender"] = torch.as_tensor(np.asarray(table.gender),
                                            dtype=torch.long, device=device)
    return tbl, genders


def _gendered_mesh_cam(synth, tbl, genders, idx, pose, shape, trans, cam_r,
                       cam_t):
    """mesh_cam over every gender present in the table and a per-row
    select (torch.where); exactly one forward for all-neutral tables."""
    out = None
    for g in genders:
        mesh_mm, _ = mesh_cam_fn(synth.params[g], synth.mean_betas[g],
                                 pose, shape, trans, cam_r, cam_t)
        if out is None:
            out = mesh_mm
        else:
            sel = (tbl["gender"][idx] == GENDERS.index(g))[:, None, None]
            out = torch.where(sel, mesh_mm, out)
    return out


def with_device_input_pipeline_gat(step_fn: Callable, table, jset, opts,
                                   device="cuda") -> Callable:
    """The stage-1 (GAT lifter) form of `with_device_input_pipeline`: no
    SMPL synthesis; the step assembles {pose2d, joint_cam, joint_valid}
    from the table on `device` (reference per sample:
    Human36M/dataset.py:409-419)."""
    device = torch.device(device)
    tbl, _ = _check_and_load_table(table, opts, need_smpl=False,
                                   device=device)
    perm = _perm_on(_flip_perm(jset.joint_num, jset.flip_pairs), device)
    input_shape = tuple(opts.input_shape)

    def assemble(state, batch, *extra):
        batch = leaves_on(batch, device)
        idx = batch["idx"].long()
        flips, rots = batch["flips"], batch["rots"]
        jc = tbl["joint_cam"][idx]
        jh = jc - jc[:, :1]
        return {
            "pose2d": crop_normalize_gt(tbl["joint_img"][idx], perm,
                                        input_shape, flips, rots),
            "joint_cam": j3d_augment(jh, perm, flips, rots),
            "joint_valid": torch.ones((idx.shape[0], 1, 1), device=device),
        }

    return with_assembly(step_fn, assemble)


def precompute_rows(fn: Callable, n: int, device, chunk: int = 2048):
    """`fn(rows [chunk] long) -> tuple of [chunk, ...] tensors` over all n
    rows in chunks, concatenated to a tuple of [n, ...] tensors."""
    parts = [fn(torch.arange(lo, min(lo + chunk, n), device=device))
             for lo in range(0, n, chunk)]
    return tuple(torch.cat(cols) for cols in zip(*parts))


def with_device_input_pipeline(step_fn: Callable, synth, table, jset, opts,
                               fitting_thr: float,
                               mesh_cache: bool = False) -> Callable:
    """Wrap a stage-2 train step to run the whole input pipeline on the
    synthesizer's device from index-only batches
    (`SmplPoseDataset.make_index_batch`).

    mesh_cache=True: the GT mesh target and its fit-gate mask are the same
    for a row in every epoch (augmentation touches only the 2D input and
    the lift target, as on the host path), so they are computed once into
    [N, V, 3] and [N, 1, 1] tables and the step gathers them instead of
    running the SMPL forward. Same math, same order; it costs N*V*3*4
    bytes of device memory (the session gates it by size,
    cfg.TRAIN.gt_mesh_cache)."""
    device = synth.device
    tbl, genders = _check_and_load_table(table, opts, need_smpl=True,
                                         device=device)
    perm = _perm_on(_flip_perm(jset.joint_num, jset.flip_pairs), device)
    input_shape = tuple(opts.input_shape)

    def mesh_and_valid(idx):
        """Rows -> (mesh_rel [B, V, 3] metres, valid [B, 1, 1]): the part
        of the targets that is the same in every epoch."""
        no_tf32()
        with span("step.gt"):
            jc = tbl["joint_cam"][idx]
            jh = jc - jc[:, :1]
            mesh_mm = _gendered_mesh_cam(
                synth, tbl, genders, idx, tbl["pose"][idx],
                tbl["shape"][idx], tbl["trans"][idx], tbl["cam_r"][idx],
                tbl["cam_t"][idx])
            fit = fitting_error_fn(synth.j_reg_h36m, jh, mesh_mm)
            return (((mesh_mm - jc[:, :1]) / 1000.0).float(),
                    fit_valid_mask_fn(fit, fitting_thr))

    if mesh_cache:
        with torch.no_grad():
            tbl["mesh_rel"], tbl["fit_valid"] = precompute_rows(
                mesh_and_valid, len(table), device)

    def assemble(state, batch, *extra):
        batch = leaves_on(batch, device)
        idx = batch["idx"].long()
        flips, rots = batch["flips"], batch["rots"]
        jc = tbl["joint_cam"][idx]
        jh = jc - jc[:, :1]
        if mesh_cache:
            mesh, valid = tbl["mesh_rel"][idx], tbl["fit_valid"][idx]
        else:
            mesh, valid = mesh_and_valid(idx)
        return {
            "pose2d": crop_normalize_gt(tbl["joint_img"][idx], perm,
                                        input_shape, flips, rots),
            "mesh": mesh,
            "lift_pose3d": j3d_augment(jh, perm, flips, rots),
            "reg_pose3d": jh.float(),
            "mesh_valid": valid,
            "lift_valid": torch.ones_like(valid),
            "reg_valid": torch.ones_like(valid),
        }

    return with_assembly(step_fn, assemble)
