"""The packed device pipeline (counterpart of gator_tpu/data/packed.py):
the detector-input, mixed-dataset and gendered generalisation of
`device_pipeline`, for TRAIN.gt_in_step "packed" and "device".

One canonical table concatenates the per-row columns of every dataset in
the mix, each from its `packed_rows` hook (the dataset's own SMPL path:
camera-rotated H36M [Human36M/dataset.py:254-300], plain COCO SMPLify fits
[COCO/dataset.py:147-166], translated MuCo [MuCo/dataset.py:196-216],
virtual-camera AMASS [AMASS/dataset.py:186-213], folded into (pose_eff,
shape_eff, trans_off) with mesh = forward(pose_eff, shape_eff) +
trans_off), the 2D input joints (COCO input derives from the fitted mesh,
COCO/dataset.py:182-194) and the fitting-filter masks with each dataset's
zeroing policy. `build_packed_tables` builds it once a session, on the
synthesizer's device, and keeps it as host numpy; the step wrapper copies
what it reads to the device once.

  * "packed": the host assembles the 2D input (`base.input_pose2d`, the
    host path's own code and draws) and ships (row, flips, rots, pose2d);
    every target is gathered and synthesised on the device.
  * "device": batches are (row, flips, rots) only (`make_device_batch`,
    ~12 B a sample), and the 2D input, detector noise included
    (`device_noise`), is built on the device too. The noise stream is
    keyed per optimizer step from the step's seed, salted apart from the
    dropout stream: a device generator seeded with
    `step_seed(seed ^ _NOISE_SALT, state.step)`, reproducible from
    (seed, step). A data-parallel rank (`world=`) draws the global batch's
    uniforms and normals and keeps its rows (`device_noise.RowDraws`)
    before the candidate work, so its noise is what the one-device step
    draws for those rows.

Gendered rows take one SMPL forward per gender present in the table (a
build-time set) and a per-row `torch.where` select (reference:
lib/smpl.py:11-52).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..bodymodel.smpl import smpl_forward
from ..nn.dropout_masks import step_seed
from ..precision import no_tf32
from ..profiling import span
from . import processing
from .augment import augm_params_batch
from .base import input_pose2d
from .device_noise import (RowDraws, h36m_syn_error_device,
                           synthesize_pose_device, wave_constants)
from .device_pipeline import (_flip_perm, _perm_on, affine_crop,
                              flip_standardize, j3d_augment, leaves_on,
                              precompute_rows, with_assembly)
from .gt_synth import prep_shape_fn, rotate_root_pose

GENDER_CODES = {"neutral": 0, "female": 1, "male": 2}

# salt that keys the in-step detector-noise stream apart from the dropout
# stream of the same step (gator_tpu/data/packed.py:62)
_NOISE_SALT = 0x6E6F69


@dataclasses.dataclass
class PackedTable:
    """Canonical per-row columns over the concatenated datasets (host
    numpy; the step wrapper copies them to the device)."""

    pose_eff: np.ndarray         # [N, 72] effective axis-angle
    shape_eff: np.ndarray        # [N, 10] cleaned/substituted betas
    trans_off: np.ndarray        # [N, 3] mesh = fwd(...) + trans_off (m)
    root_mm: np.ndarray          # [N, 3] root joint (mm) for mesh_rel
    joint_cam_input: np.ndarray  # [N, J, 3] root-rel lift target (mm)
    reg_pose: np.ndarray         # [N, 17, 3] root-rel h36m target (mm)
    mesh_valid: np.ndarray       # [N] f32 fit gates (dataset policies
    reg_valid: np.ndarray        # [N]     pre-applied)
    lift_valid: np.ndarray       # [N]
    gat_valid: np.ndarray        # [N]
    gender: np.ndarray           # [N] int32 (GENDER_CODES)
    joint_img_input: np.ndarray  # [N, J, 2] input pixel joints
    # "device" mode: per-row OKS crop area (the detector-noise radii), the
    # rows whose dataset applies h36m Gaussian noise, and its [J, 5] stats
    crop_area: Optional[np.ndarray] = None       # [N] f32
    h36m_noise_on: Optional[np.ndarray] = None   # [N] f32 0/1
    h36m_stats: Optional[np.ndarray] = None      # [J, 5] or None

    def __len__(self):
        return self.pose_eff.shape[0]

    @property
    def genders_present(self):
        return tuple(g for g, c in GENDER_CODES.items()
                     if (self.gender == c).any())


@dataclasses.dataclass
class PackedView:
    """A dataset's host-side view, read by `make_packed_batch`."""

    joint_img_input: np.ndarray   # [n, J, 2]
    row_offset: int
    h36m_stats: Optional[np.ndarray]


def valid_masks(bad: np.ndarray, zero_gator=("mesh",),
                zero_gat: bool = False) -> Dict[str, np.ndarray]:
    """The per-row fit-gate masks of a dataset's zeroing policy (the
    bad_zero_* arguments of `base.assemble_batch`)."""
    good = (~np.asarray(bad, bool)).astype(np.float32)
    ones = np.ones_like(good)
    return {
        "mesh_valid": good if "mesh" in zero_gator else ones,
        "reg_valid": good if "reg" in zero_gator else ones,
        "lift_valid": good if "lift" in zero_gator else ones,
        "gat_valid": good if zero_gat else ones,
    }


_COLUMNS = ("pose_eff", "shape_eff", "trans_off", "root_mm",
            "joint_cam_input", "reg_pose", "mesh_valid", "reg_valid",
            "lift_valid", "gat_valid", "gender", "joint_img_input")


def build_packed_tables(datasets: Sequence, synth,
                        chunk: int = 2048) -> PackedTable:
    """Every dataset's `packed_rows` in chunks, concatenated into one
    table, and each dataset's `PackedView` attached (which its
    `make_packed_batch` reads). One SMPL pass over the table."""
    cols: Dict[str, list] = {k: [] for k in _COLUMNS}
    offset = 0
    areas = []
    for ds in datasets:
        if not hasattr(ds, "packed_rows"):
            raise ValueError(
                f"{type(ds).__name__} has no packed_rows precompute — "
                "the packed device pipeline cannot cover it")
        imgs = []
        for i in range(0, len(ds), chunk):
            rows = ds.packed_rows(synth, np.arange(i, min(i + chunk,
                                                          len(ds))))
            for k in _COLUMNS:
                cols[k].append(np.asarray(rows[k]))
            imgs.append(np.asarray(rows["joint_img_input"]))
        ds._packed = PackedView(
            joint_img_input=np.concatenate(imgs).astype(np.float32),
            row_offset=offset,
            h36m_stats=getattr(ds, "_h36m_stats", None))
        # the OKS crop area of each row, from its input joints and its own
        # dataset's crop geometry, as the host path computes it
        areas.append(processing.crop_area_batch(
            ds._packed.joint_img_input, ds.opts))
        offset += len(ds)
    table = PackedTable(**{k: np.concatenate(cols[k]) for k in _COLUMNS})
    table.crop_area = np.concatenate(areas)
    noise_on, stats = [], None
    for ds in datasets:
        s = ds._packed.h36m_stats
        noise_on.append(np.full(len(ds), 0.0 if s is None else 1.0,
                                np.float32))
        if s is not None:
            if stats is not None and not np.array_equal(stats, s):
                raise ValueError("packed table: datasets disagree on "
                                 "h36m noise stats")
            stats = np.asarray(s, np.float32)
    table.h36m_noise_on = np.concatenate(noise_on)
    table.h36m_stats = stats
    return table


def make_packed_batch(ds, indices: np.ndarray,
                      rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Host batch of the "packed" mode: global row ids, augmentation
    parameters and the assembled 2D input (`base.input_pose2d`: the host
    path's code and rng draws). Stage-agnostic: the step wrapper picks the
    targets."""
    pk: PackedView = ds._packed
    idx = np.asarray(indices)
    opts = ds.opts
    flips, rots = augm_params_batch(
        opts.is_train, opts.flip_enabled, opts.rotate_factor, len(idx), rng)
    pose2d = input_pose2d(opts, ds.joint_set, rng, pk.joint_img_input[idx],
                          flips, rots, h36m_stats=pk.h36m_stats)
    return {"row": (pk.row_offset + idx).astype(np.int32),
            "flips": flips.astype(np.float32),
            "rots": rots.astype(np.float32),
            "pose2d": pose2d}


def make_device_batch(ds, indices: np.ndarray,
                      rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Host batch of the "device" mode: global row ids and augmentation
    parameters only (~12 B a sample); the 2D input, detector noise
    included, is built in the step. Stage-agnostic."""
    pk: PackedView = ds._packed
    idx = np.asarray(indices)
    opts = ds.opts
    flips, rots = augm_params_batch(
        opts.is_train, opts.flip_enabled, opts.rotate_factor, len(idx), rng)
    return {"row": (pk.row_offset + idx).astype(np.int32),
            "flips": flips.astype(np.float32),
            "rots": rots.astype(np.float32)}


def gendered_smpl_verts(params_by_gender: Dict, genders_present,
                        gender_codes: Optional[torch.Tensor],
                        pose: torch.Tensor,
                        shape: torch.Tensor) -> torch.Tensor:
    """[B, V, 3] SMPL vertices: one forward per gender present (a static
    set) and a per-row torch.where select; exactly one forward for
    all-neutral tables (reference gendered layers: lib/smpl.py:11-52)."""
    out = None
    for g in genders_present:
        verts, _ = smpl_forward(params_by_gender[g], pose, shape)
        if out is None:
            out = verts
        else:
            sel = (gender_codes == GENDER_CODES[g])[:, None, None]
            out = torch.where(sel, verts, out)
    return out


def with_packed_input_pipeline(step_fn: Callable, table: PackedTable,
                               synth, jset, stage: str = "gator",
                               opts=None, device_input: bool = False,
                               mesh_cache: bool = False,
                               world=None) -> Callable:
    """Wrap a train step to assemble every target on the synthesizer's
    device from the packed table: gather the rows, synthesise the GT mesh
    (per-present-gender SMPL), augment the lift target and gather the fit
    gates.

    device_input=False ("packed"): the batch carries the host-assembled 2D
    input (row, flips, rots, pose2d). device_input=True ("device"): the
    batch is (row, flips, rots), and the 2D input (gather, detector noise
    keyed per step, crop/flip/normalise) is built on the device too; it
    needs `opts` (the session's ProcessOptions) and a table from
    `build_packed_tables`.

    mesh_cache=True (gator stage): the GT mesh of a row is the same in
    every epoch (no augmentation touches it), so it is computed once into
    an [N, V, 3] table and the step gathers it. Costs N*V*3*4 bytes of
    device memory (the session gates it by size, cfg.TRAIN.gt_mesh_cache).

    world: a data-parallel rank's batch holds its rows of the global
    batch; the detector noise is drawn for the global batch and sliced
    (module docstring).
    """
    device = synth.device
    want_coco_noise = want_h36m_noise = False
    if device_input:
        if opts is None:
            raise ValueError("device_input=True needs the session opts")
        if table.crop_area is None:
            raise ValueError("device_input=True needs a table built by "
                             "build_packed_tables (crop_area column)")
        input_shape = tuple(opts.input_shape)
        want_coco_noise = (opts.is_train and not opts.use_gt_input
                           and opts.input_joint_name == "coco")
        want_h36m_noise = (opts.is_train and not opts.use_gt_input
                           and opts.input_joint_name == "human36"
                           and table.h36m_stats is not None)
    perm = _perm_on(_flip_perm(jset.joint_num, jset.flip_pairs), device)
    genders = table.genders_present

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    tbl = {"joint_cam_input": f32(table.joint_cam_input),
           "gat_valid": f32(table.gat_valid)}
    if device_input:
        tbl["joint_img_input"] = f32(table.joint_img_input)
        if want_coco_noise:
            tbl["crop_area"] = f32(table.crop_area)
            wave_constants(tbl["crop_area"].device)   # its tables, once
        if want_h36m_noise:
            tbl["h36m_noise_on"] = f32(table.h36m_noise_on)
            tbl["h36m_stats"] = f32(table.h36m_stats)
    if stage == "gator":
        tbl.update({
            "pose_eff": f32(table.pose_eff),
            "shape_eff": f32(table.shape_eff),
            # the root subtraction folds into the per-row offset:
            # mesh_target = fwd(pose_eff, shape_eff) + trans_off - root
            "offset_m": f32(table.trans_off - table.root_mm / 1000.0),
            "reg_pose": f32(table.reg_pose),
            "mesh_valid": f32(table.mesh_valid),
            "reg_valid": f32(table.reg_valid),
            "lift_valid": f32(table.lift_valid),
        })
    if len(genders) > 1:
        tbl["gender"] = torch.as_tensor(table.gender, dtype=torch.long,
                                        device=device)
    noise_gen = (torch.Generator(device=device)
                 if want_coco_noise or want_h36m_noise else None)
    draws = noise_gen
    if noise_gen is not None and world is not None and world.size > 1:
        draws = RowDraws(noise_gen, world.rank, world.size)

    def mesh_rows(row):
        """Rows -> GT mesh target [B, V, 3] (metres, root-relative)."""
        no_tf32()
        with span("step.gt"):
            codes = tbl["gender"][row] if len(genders) > 1 else None
            verts = gendered_smpl_verts(synth.params, genders, codes,
                                        tbl["pose_eff"][row],
                                        tbl["shape_eff"][row])
            return (verts + tbl["offset_m"][row][:, None]).float()

    if mesh_cache and stage == "gator":
        with torch.no_grad():
            (tbl["mesh_m"],) = precompute_rows(
                lambda row: (mesh_rows(row),), len(table), device)

    def device_pose2d(state, row, flips, rots, seed):
        """In-step 2D input: gather -> affine crop -> detector noise
        (keyed per optimizer step, like dropout) -> flip + standardise:
        the host path's order (processing.batch_crop_and_normalize)."""
        out = affine_crop(tbl["joint_img_input"][row], input_shape, rots)
        if noise_gen is not None:
            noise_gen.manual_seed(step_seed(int(seed) ^ _NOISE_SALT,
                                            state.step))
            with span("step.noise"):
                if want_coco_noise:
                    # noise on the 17 coco keypoints in crop space; the
                    # extra pelvis/neck rows pass through untouched
                    out = torch.cat([synthesize_pose_device(
                        draws, out[:, :17], tbl["crop_area"][row]),
                        out[:, 17:]], dim=1)
                else:
                    noise = h36m_syn_error_device(
                        draws, tbl["h36m_stats"], row.shape[0], input_shape)
                    out = out + noise * tbl["h36m_noise_on"][row][
                        :, None, None]
        return flip_standardize(out, perm, input_shape, flips)

    def assemble(state, batch, seed, *extra):
        batch = leaves_on(batch, device)
        row = batch["row"].long()
        flips, rots = batch["flips"], batch["rots"]
        pose2d = (device_pose2d(state, row, flips, rots, seed)
                  if device_input else batch["pose2d"].float())
        lift = j3d_augment(tbl["joint_cam_input"][row], perm, flips, rots)
        if stage != "gator":
            return {"pose2d": pose2d, "joint_cam": lift,
                    "joint_valid": tbl["gat_valid"][row][:, None, None]}
        return {
            "pose2d": pose2d,
            "mesh": tbl["mesh_m"][row] if "mesh_m" in tbl
            else mesh_rows(row),
            "lift_pose3d": lift,
            "reg_pose3d": tbl["reg_pose"][row],
            "mesh_valid": tbl["mesh_valid"][row][:, None, None],
            "reg_valid": tbl["reg_valid"][row][:, None, None],
            "lift_valid": tbl["lift_valid"][row][:, None, None],
        }

    return with_assembly(step_fn, assemble)


# -- the readers' packed_rows hooks (host numpy in and out; the SMPL pass
#    runs on the synthesizer's device) -----------------------------------


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def smpl_pose_packed_rows(ds, synth, indices) -> Dict[str, np.ndarray]:
    """`packed_rows` of the SmplPoseDataset family (Human36M, Synthetic):
    the camera-rotated SMPL path grouped by gender (reference:
    Human36M/dataset.py:254-300,339-419)."""
    t = ds.table
    idx = np.asarray(indices)
    n = len(idx)
    opts = ds.opts
    want_coco = opts.input_joint_name == "coco"
    jh = t.joint_cam_h36m[idx] - t.joint_cam_h36m[idx][:, :1]

    pose_eff = np.empty((n, 72), np.float32)
    shape_eff = np.empty((n, 10), np.float32)
    trans_off = np.empty((n, 3), np.float32)
    fit = np.empty(n, np.float32)
    jnum = ds.joint_set.joint_num
    cam_in = np.empty((n, jnum, 3), np.float32)
    img_in = np.empty((n, jnum, 2), np.float32)
    for g_name, g_code in GENDER_CODES.items():
        sel = np.nonzero(t.gender[idx] == g_code)[0]
        if len(sel) == 0:
            continue
        sub = idx[sel]
        pe, se, off, mesh_mm = synth.smpl_cam_decompose(
            t.pose[sub], t.shape[sub], t.trans[sub], t.cam_r[sub],
            t.cam_t[sub], g_name)
        pose_eff[sel] = _np(pe)
        shape_eff[sel] = _np(se)
        trans_off[sel] = _np(off)
        fit[sel] = _np(synth.fitting_error(jh[sel], mesh_mm))
        if want_coco:
            cam, img = synth.coco_from_mesh(mesh_mm, t.focal[sub],
                                            t.princpt[sub])
            cam, img = _np(cam), _np(img)
            cam_in[sel] = cam - cam[:, -2:-1]
            img_in[sel] = img[..., :2]
    if not want_coco:
        cam_in = jh.astype(np.float32)
        img_in = t.joint_img_h36m[idx][..., :2].astype(np.float32)

    bad = fit > opts.fitting_thr
    # the host path's policies (base._assemble): COCO input zeroes mesh and
    # lift (gator) and joint_valid (gat); h36m input gates the mesh only
    masks = valid_masks(bad,
                        zero_gator=("mesh", "lift") if want_coco
                        else ("mesh",),
                        zero_gat=want_coco)
    return dict(
        pose_eff=pose_eff, shape_eff=shape_eff, trans_off=trans_off,
        root_mm=t.joint_cam_h36m[idx][:, 0].astype(np.float32),
        joint_cam_input=cam_in, reg_pose=jh.astype(np.float32),
        gender=t.gender[idx].astype(np.int32),
        joint_img_input=img_in, **masks)


def coco_packed_rows(ds, synth, indices) -> Dict[str, np.ndarray]:
    """`packed_rows` of CocoDataset: plain SMPLify fits, weak-perspective
    projection, the 64x64-crop 2D fitting filter (reference:
    COCO/dataset.py:147-214)."""
    t = ds.table
    idx = np.asarray(indices)
    pose = t.pose[idx]
    shape = t.shape[idx]
    # plain path: no camera rotation, no translation; only the beta
    # cleaning folds into shape_eff
    mesh_mm, _ = synth.smpl_mesh_plain(pose, shape, "neutral", True)
    se = _np(prep_shape_fn(synth._t(shape), synth.mean_betas["neutral"],
                           True))
    coco_cam, coco_img = synth.coco_weak_perspective(
        mesh_mm, t.cam_s[idx], t.cam_t[idx])
    coco_cam, coco_img = _np(coco_cam), _np(coco_img)
    h36m_cam = _np(synth.h36m_from_mesh(mesh_mm))
    jh = h36m_cam - h36m_cam[:, :1]
    fit = ds._fitting_error_2d_batch(
        t.bbox[idx], t.joint_img[idx], t.joint_valid[idx],
        coco_img[:, :17])
    # COCO zeroes every validity mask on a bad fit (dataset.py:270)
    masks = valid_masks(fit > ds.opts.fitting_thr,
                        zero_gator=("mesh", "reg", "lift"), zero_gat=True)
    return dict(
        pose_eff=pose.astype(np.float32), shape_eff=se,
        trans_off=np.zeros((len(idx), 3), np.float32),
        root_mm=h36m_cam[:, 0].astype(np.float32),
        joint_cam_input=(coco_cam - coco_cam[:, -2:-1]).astype(np.float32),
        reg_pose=jh.astype(np.float32),
        gender=np.zeros(len(idx), np.int32),
        joint_img_input=coco_img[..., :2].astype(np.float32), **masks)


def muco_packed_rows(ds, synth, indices) -> Dict[str, np.ndarray]:
    """`packed_rows` of MucoDataset: SMPL with in-layer translation, full
    cameras, the 45 mm fitting filter (reference:
    MuCo/dataset.py:196-262)."""
    t = ds.table
    idx = np.asarray(indices)
    n = len(idx)
    mesh_mm, _ = synth.smpl_mesh_direct(
        t.pose[idx], t.shape[idx], t.trans[idx], "neutral", True)
    coco_cam, coco_img = synth.coco_from_mesh(
        mesh_mm, t.focal[idx], t.princpt[idx])
    coco_cam, coco_img = _np(coco_cam), _np(coco_img)
    h36m_cam = _np(synth.h36m_from_mesh(mesh_mm))
    jh = h36m_cam - h36m_cam[:, :1]
    fit = ds._fitting_error_batch(t.joint_cam_muco[idx], mesh_mm)
    # the shape cleaning folds in (smpl_mesh_direct clean=True); the
    # translation rides in the layer -> trans_off = trans
    shape_eff = _np(prep_shape_fn(synth._t(t.shape[idx]),
                                  synth.mean_betas["neutral"], True))
    if ds.opts.input_joint_name == "coco":
        cam_in = (coco_cam - coco_cam[:, -2:-1]).astype(np.float32)
        img_in = coco_img[..., :2].astype(np.float32)
    else:
        ji = (h36m_cam[..., :2] / h36m_cam[..., 2:3]
              * t.focal[idx][:, None, :] + t.princpt[idx][:, None, :])
        cam_in, img_in = jh.astype(np.float32), ji.astype(np.float32)
    # MuCo zeroes every gator mask on a bad fit but not the gat mask
    # (reference: dataset.py:316-319)
    masks = valid_masks(fit > ds.opts.fitting_thr,
                        zero_gator=("mesh", "reg", "lift"), zero_gat=False)
    return dict(
        pose_eff=t.pose[idx].astype(np.float32), shape_eff=shape_eff,
        trans_off=t.trans[idx].astype(np.float32),
        root_mm=h36m_cam[:, 0].astype(np.float32),
        joint_cam_input=cam_in, reg_pose=jh.astype(np.float32),
        gender=np.zeros(n, np.int32), joint_img_input=img_in, **masks)


def amass_packed_rows(ds, synth, indices) -> Dict[str, np.ndarray]:
    """`packed_rows` of AmassDataset: camera-rotated root plus an additive
    translation in metres, exact mocap GT (no fitting filter) (reference:
    AMASS/dataset.py:186-238)."""
    from .amass import CAM_T_M, FOCAL, PRINCPT

    t = ds.table
    idx = np.asarray(indices)
    n = len(idx)
    cam_t = np.tile(CAM_T_M, (n, 1))
    mesh_mm, _ = synth.smpl_mesh_rotated(
        t.pose[idx], t.shape[idx], t.cam_r[idx], cam_t)
    pose_eff = _np(rotate_root_pose(synth._t(t.pose[idx]),
                                    synth._t(t.cam_r[idx])))
    shape_eff = _np(prep_shape_fn(synth._t(t.shape[idx]),
                                  synth.mean_betas["neutral"], False))
    focal = np.tile(FOCAL, (n, 1))
    princpt = np.tile(PRINCPT, (n, 1))
    coco_cam, coco_img = synth.coco_from_mesh(mesh_mm, focal, princpt)
    coco_cam, coco_img = _np(coco_cam), _np(coco_img)
    h36m_cam = _np(synth.h36m_from_mesh(mesh_mm))
    jh = h36m_cam - h36m_cam[:, :1]
    if ds.opts.input_joint_name == "coco":
        cam_in = (coco_cam - coco_cam[:, -2:-1]).astype(np.float32)
        img_in = coco_img[..., :2].astype(np.float32)
    else:
        xy = (h36m_cam[..., :2] / h36m_cam[..., 2:3]
              * FOCAL[None, None] + PRINCPT[None, None])
        cam_in, img_in = jh.astype(np.float32), xy.astype(np.float32)
    masks = valid_masks(np.zeros(n, bool))
    return dict(
        pose_eff=pose_eff, shape_eff=shape_eff,
        trans_off=cam_t.astype(np.float32),
        root_mm=h36m_cam[:, 0].astype(np.float32),
        joint_cam_input=cam_in, reg_pose=jh.astype(np.float32),
        gender=np.zeros(n, np.int32), joint_img_input=img_in, **masks)
