"""Train steps of both stages (counterpart of gator_tpu/train/loop.py:25
`make_gator_train_step` and :162 `make_gat_train_step`), on the training
kernels K4 and K5.

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

from .. import losses
from ..nn.dropout_masks import step_seed
from .fused_forward import gat_train_forward, gat_trunk_fn, make_fused_forward
from .state import TrainState

Batch = Dict[str, torch.Tensor]


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
    targets. edge_enabled: 0 or 1, the epoch-gated edge term. dtype=bf16
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
        _no_tf32()
        model = state.model
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
    joint_valid [B,J,1]. GatMlp's dropout is fixed at `mlp_rate` = 0.1
    (the reference's quirk, kept by the JAX step)."""
    j = spec.num_joint

    def step(state: TrainState, batch: Batch, seed: int
             ) -> Dict[str, torch.Tensor]:
        _no_tf32()
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
