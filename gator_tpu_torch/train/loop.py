"""Train and eval steps of both stages (counterpart of
gator_tpu/train/loop.py:25 `make_gator_train_step`, :162
`make_gat_train_step`, :120 `make_gator_eval_step` and :227
`make_gat_eval_step`). The train steps run on the training kernels K4 and
K5; the eval steps run the module form, whose MDR vertex self-attention is
K3.

A step runs the forward in the compute dtype from the module's f32 master
weights, the losses in f32, backward, and one optimizer step. The kernels'
dropout seed for a step is `step_seed(seed, state.step)`, as the JAX steps
fold the step counter into their PRNG key. TF32 is switched off for the
step's f32 products (the JAX package pins Precision.HIGHEST for the joint
regression, loop.py:96-97).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np
import torch

from .. import losses, metrics
from ..nn.dropout_masks import step_seed
from ..precision import no_tf32
from .fused_forward import gat_train_forward, gat_trunk_fn, make_fused_forward
from .state import TrainState

Batch = Dict[str, torch.Tensor]


def make_gator_train_step(spec, faces: np.ndarray,
                          j_regressor_target: np.ndarray,
                          weights: losses.LossWeights,
                          dtype: torch.dtype = torch.float32,
                          use_kernels: bool = True, rates=None,
                          gat_mlp_rate: float = 0.1) -> Callable:
    """Stage-2 step -> step(state, batch, seed, edge_enabled) -> metrics.

    batch (gator_tpu/train/loop.py:37-41): pose2d [B,J,2], mesh [B,V,3]
    (m), lift_pose3d [B,J,3] (mm), reg_pose3d [B,17,3] (mm), and validity
    masks mesh_valid / lift_valid / reg_valid broadcasting against their
    targets; host arrays are copied to the model's device. edge_enabled: 0 or 1, the epoch-gated edge term. dtype=bf16
    computes the model in bf16 from f32 master weights; the face losses
    then run in bf16 with f32 reductions, the rest of the loss in f32. The
    BatchNorm running stats (alpha=False) are updated in place."""
    fwd = make_fused_forward(spec, dtype=dtype, rates=rates,
                             use_kernels=use_kernels,
                             gat_mlp_rate=gat_mlp_rate)
    j_reg_np = np.asarray(j_regressor_target, dtype=np.float32)
    face_dtype = dtype if dtype != torch.float32 else None

    @functools.lru_cache(maxsize=None)
    def j_reg_on(device: torch.device) -> torch.Tensor:
        # copied to each device once, not on every step
        return torch.as_tensor(j_reg_np, device=device)

    def step(state: TrainState, batch: Batch, seed: int,
             edge_enabled: float = 1.0) -> Dict[str, torch.Tensor]:
        no_tf32()
        model = state.model
        batch = _batch_on(batch, model)
        state.optimizer.zero_grad(set_to_none=True)
        mesh, lift_pose, new_stats = fwd(model, batch["pose2d"],
                                         step_seed(seed, state.step))
        mesh = mesh.float()
        lift_pose = lift_pose.float()
        # mesh -> target-joint regression in mm, in true f32
        pred_pose = torch.einsum("jv,bvc->bjc", j_reg_on(mesh.device),
                                 mesh * 1000.0)
        out = losses.gator_loss(
            mesh, pred_pose, lift_pose, batch["mesh"], batch["reg_pose3d"],
            batch["lift_pose3d"], batch["mesh_valid"], batch["reg_valid"],
            batch["lift_valid"], faces, weights, edge_enabled,
            face_loss_dtype=face_dtype)
        out.total.backward()
        state.apply_gradients()
        if new_stats is not None:
            bn = model.pose2mesh.bias_norm
            with torch.no_grad():
                bn.running_mean.copy_(new_stats[0])
                bn.running_var.copy_(new_stats[1])
        return {"loss": out.total.detach(), "vertex": out.vertex.detach(),
                "normal": out.normal.detach(), "edge": out.edge.detach(),
                "reg_joint": out.reg_joint.detach(),
                "lift_joint": out.lift_joint.detach()}

    return step


def make_gat_train_step(spec, dtype: torch.dtype = torch.float32,
                        use_kernels: bool = True,
                        mlp_rate: float = 0.1) -> Callable:
    """Stage-1 (lifter pretrain) step on K5 -> step(state, batch, seed) ->
    {"loss"}: CoordLoss on the lifted joints (reference:
    lib/core/base.py:279-315). batch: pose2d [B,J,2], joint_cam [B,J,3],
    joint_valid [B,J,1], host arrays copied to the model's device. GatMlp's dropout is fixed at `mlp_rate` = 0.1
    (the reference's quirk, kept by the JAX step)."""
    j = spec.num_joint

    def step(state: TrainState, batch: Batch, seed: int
             ) -> Dict[str, torch.Tensor]:
        no_tf32()
        batch = _batch_on(batch, state.model)
        state.optimizer.zero_grad(set_to_none=True)
        trunk = gat_trunk_fn(spec, step_seed(seed, state.step), use_kernels,
                             mlp_rate)
        pose3d, _ = gat_train_forward(state.model, batch["pose2d"], dtype,
                                      trunk)
        loss = losses.coord_l1_loss(pose3d.reshape(-1, j, 3).float(),
                                    batch["joint_cam"], batch["joint_valid"])
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach()}

    return step


def make_gator_eval_step(j_regressor_target: np.ndarray, eval_joints,
                         use_kernels: bool = True) -> Callable:
    """Per-batch eval of a GATOR -> step(model, batch) -> per-sample
    `joint_err` and `surface_err` [B] (mm) and the predictions
    `pred_mesh_mm` [B, V, 3], `pred_pose_mm` [B, 17, 3], with
    compute_both_err's semantics (reference: Human36M/dataset.py:466-478).
    The caller sums over batches (`run_eval`). The model runs in f32 with
    TF32 off, the counterpart of the JAX step's
    default_matmul_precision("highest") (loop.py:136-148); use_kernels=False
    keeps the MDR self-attention off K3. batch: pose2d, mesh (m),
    reg_pose3d (mm); host arrays are copied to the model's device."""
    j_reg_np = np.asarray(j_regressor_target, dtype=np.float32)
    eval_idx = tuple(eval_joints) if eval_joints is not None else None

    @functools.lru_cache(maxsize=None)
    def j_reg_on(device: torch.device) -> torch.Tensor:
        return torch.as_tensor(j_reg_np, device=device)

    def step(model, batch: Batch) -> Dict[str, torch.Tensor]:
        no_tf32()
        dev = next(model.parameters()).device
        with torch.no_grad():
            mesh, _ = model(_on(batch["pose2d"], dev), use_kernels)
            mesh_mm = mesh.float() * 1000.0
            gt_mesh_mm = _on(batch["mesh"], dev) * 1000.0
            pred_pose = torch.einsum("jv,bvc->bjc", j_reg_on(dev), mesh_mm)
            gt_pose = _on(batch["reg_pose3d"], dev)
            # meshes aligned by their joint roots, joints by their own
            s_err = metrics.mpvpe(mesh_mm, gt_mesh_mm, pred_pose[:, :1],
                                  gt_pose[:, :1], per_sample=True)
            j_err = metrics.mpjpe(pred_pose, gt_pose, eval_joints=eval_idx,
                                  per_sample=True)
        return {"joint_err": j_err, "surface_err": s_err,
                "pred_mesh_mm": mesh_mm, "pred_pose_mm": pred_pose}

    return step


def make_gat_eval_step(eval_joints) -> Callable:
    """Per-batch eval of a GAT lifter -> step(model, batch) -> per-sample
    `joint_err` [B] (mm) and `pred_pose_mm` [B, J, 3]; f32, TF32 off.
    batch: pose2d, joint_cam (mm)."""
    eval_idx = tuple(eval_joints) if eval_joints is not None else None

    def step(model, batch: Batch) -> Dict[str, torch.Tensor]:
        no_tf32()
        dev = next(model.parameters()).device
        with torch.no_grad():
            pose2d = _on(batch["pose2d"], dev)
            pose3d, _ = model(pose2d.reshape(pose2d.shape[0], -1))
            pose3d = pose3d.float().reshape(-1, model.spec.num_joint, 3)
            err = metrics.mpjpe(pose3d, _on(batch["joint_cam"], dev),
                                eval_joints=eval_idx, per_sample=True)
        return {"joint_err": err, "pred_pose_mm": pose3d}

    return step


def _on(x, device) -> torch.Tensor:
    """A batch leaf (host array or tensor) as f32 on `device`."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _batch_on(batch: Batch, model: torch.nn.Module) -> Batch:
    """Every leaf of a batch (host arrays from `data.BatchPipeline`, or
    tensors) as f32 on the model's device; a leaf already there is not
    copied."""
    dev = next(model.parameters()).device
    return {k: _on(v, dev) for k, v in batch.items()}
