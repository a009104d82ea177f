"""Train and eval steps of both stages (counterpart of
gator_tpu/train/loop.py:25 `make_gator_train_step`, :162
`make_gat_train_step`, :120 `make_gator_eval_step` and :227
`make_gat_eval_step`, :253 `with_gt_synthesis`). The train steps run on
the training kernels K4 and K5; the eval steps run the module form, whose
MDR vertex self-attention is K3.

A step runs the forward in the compute dtype from the module's f32 master
weights, the losses in f32, backward, and one optimizer step. The kernels'
dropout seed for a step is `step_seed(seed, state.step)`, as the JAX steps
fold the step counter into their PRNG key. TF32 is switched off for the
step's f32 products (the JAX package pins Precision.HIGHEST for the joint
regression, loop.py:96-97). A train step's phases are the spans
step.forward, step.loss, step.backward, step.allreduce and step.optimizer
(`profiling.span`, recorded while a torch.profiler session runs);
`with_gt_synthesis`'s mesh synthesis is step.gt.

Data parallelism (`world=`, a `parallel.World`): each rank takes its rows
[r*b, (r+1)*b) of the global batch, keys its dropout masks from global
index r*b (`sample0`), takes the BatchNorm statistics over the global
batch, averages the gradients over the ranks between backward and the
optimizer step (`parallel.all_reduce_grads`), and returns the metrics
averaged over the ranks. The losses are plain means over equal shards,
so the mean of the ranks' losses is the global batch's loss and the
averaged gradient its gradient: the step computes what the one-device
step computes on the global batch (the JAX package's `jit_data_parallel`
meaning).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np
import torch

from .. import losses, metrics
from ..nn.dropout_masks import step_seed
from ..parallel import all_reduce_grads, all_reduce_mean
from ..precision import no_tf32
from ..profiling import span
from .fused_forward import gat_train_forward, gat_trunk_fn, make_fused_forward
from .state import TrainState

Batch = Dict[str, torch.Tensor]


def make_gator_train_step(spec, faces: np.ndarray,
                          j_regressor_target: np.ndarray,
                          weights: losses.LossWeights,
                          dtype: torch.dtype = torch.float32,
                          use_kernels: bool = True, rates=None,
                          gat_mlp_rate: float = 0.1, world=None,
                          gat_kernel=None) -> Callable:
    """Stage-2 step -> step(state, batch, seed, edge_enabled) -> metrics.

    batch (gator_tpu/train/loop.py:37-41): pose2d [B,J,2], mesh [B,V,3]
    (m), lift_pose3d [B,J,3] (mm), reg_pose3d [B,17,3] (mm), and validity
    masks mesh_valid / lift_valid / reg_valid broadcasting against their
    targets; host arrays are copied to the model's device. edge_enabled: 0 or 1, the epoch-gated edge term. dtype=bf16
    computes the model in bf16 from f32 master weights; the face losses
    then run in bf16 with f32 reductions, the rest of the loss in f32. The
    BatchNorm running stats (alpha=False) are updated in place. With
    `world`, the batch is this rank's rows of the global batch (module
    docstring). `gat_kernel` (default: `use_kernels`) runs the GAT trunk
    on K5 or on its plain version apart from the LBF stack (a lever of
    `tools.exp_train_ablate`). `step.forward_loss(state, batch, seed,
    edge_enabled)` -> (the losses, the new BatchNorm stats or None) is the
    step's forward and loss alone, on the same masks."""
    fwd = make_fused_forward(spec, dtype=dtype, rates=rates,
                             use_kernels=use_kernels,
                             gat_mlp_rate=gat_mlp_rate,
                             gat_kernel=gat_kernel)
    j_reg_np = np.asarray(j_regressor_target, dtype=np.float32)
    face_dtype = dtype if dtype != torch.float32 else None

    @functools.lru_cache(maxsize=None)
    def j_reg_on(device: torch.device) -> torch.Tensor:
        # copied to each device once, not on every step
        return torch.as_tensor(j_reg_np, device=device)

    def forward_loss(state: TrainState, batch: Batch, seed: int,
                     edge_enabled: float = 1.0):
        no_tf32()
        model = state.model
        batch = _batch_on(batch, model)
        with span("step.forward"):
            mesh, lift_pose, new_stats = fwd(
                model, batch["pose2d"], step_seed(seed, state.step),
                _sample0(batch, world), world)
        with span("step.loss"):
            mesh = mesh.float()
            lift_pose = lift_pose.float()
            # mesh -> target-joint regression in mm, in true f32
            pred_pose = torch.einsum("jv,bvc->bjc", j_reg_on(mesh.device),
                                     mesh * 1000.0)
            out = losses.gator_loss(
                mesh, pred_pose, lift_pose, batch["mesh"],
                batch["reg_pose3d"], batch["lift_pose3d"],
                batch["mesh_valid"], batch["reg_valid"],
                batch["lift_valid"], faces, weights, edge_enabled,
                face_loss_dtype=face_dtype)
        return out, new_stats

    def step(state: TrainState, batch: Batch, seed: int,
             edge_enabled: float = 1.0) -> Dict[str, torch.Tensor]:
        model = state.model
        state.optimizer.zero_grad(set_to_none=True)
        out, new_stats = forward_loss(state, batch, seed, edge_enabled)
        with span("step.backward"):
            out.total.backward()
        with span("step.allreduce"):
            all_reduce_grads(list(model.parameters()), world)
        with span("step.optimizer"):
            state.apply_gradients()
        if new_stats is not None:
            bn = model.pose2mesh.bias_norm
            with torch.no_grad():
                bn.running_mean.copy_(new_stats[0])
                bn.running_var.copy_(new_stats[1])
        return all_reduce_mean(
            {"loss": out.total.detach(), "vertex": out.vertex.detach(),
             "normal": out.normal.detach(), "edge": out.edge.detach(),
             "reg_joint": out.reg_joint.detach(),
             "lift_joint": out.lift_joint.detach()}, world)

    step.forward_loss = forward_loss
    return step


def make_gat_train_step(spec, dtype: torch.dtype = torch.float32,
                        use_kernels: bool = True,
                        mlp_rate: float = 0.1, world=None) -> Callable:
    """Stage-1 (lifter pretrain) step on K5 -> step(state, batch, seed) ->
    {"loss"}: CoordLoss on the lifted joints (reference:
    lib/core/base.py:279-315). batch: pose2d [B,J,2], joint_cam [B,J,3],
    joint_valid [B,J,1], host arrays copied to the model's device. GatMlp's dropout is fixed at `mlp_rate` = 0.1
    (the reference's quirk, kept by the JAX step). `world` as in the
    stage-2 step."""
    j = spec.num_joint

    def step(state: TrainState, batch: Batch, seed: int
             ) -> Dict[str, torch.Tensor]:
        no_tf32()
        batch = _batch_on(batch, state.model)
        state.optimizer.zero_grad(set_to_none=True)
        with span("step.forward"):
            trunk = gat_trunk_fn(spec, step_seed(seed, state.step),
                                 use_kernels, mlp_rate,
                                 _sample0(batch, world))
            pose3d, _ = gat_train_forward(state.model, batch["pose2d"],
                                          dtype, trunk)
        with span("step.loss"):
            loss = losses.coord_l1_loss(pose3d.reshape(-1, j, 3).float(),
                                        batch["joint_cam"],
                                        batch["joint_valid"])
        with span("step.backward"):
            loss.backward()
        with span("step.allreduce"):
            all_reduce_grads(list(state.model.parameters()), world)
        with span("step.optimizer"):
            state.apply_gradients()
        return all_reduce_mean({"loss": loss.detach()}, world)

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


_RAW_BATCH_KEYS = ("smpl_pose", "smpl_shape", "smpl_trans", "cam_r",
                   "cam_t", "mesh_root_mm")


def with_gt_synthesis(step_fn: Callable, synth, fitting_thr: float,
                      gender: str = "neutral") -> Callable:
    """Fuse GT mesh synthesis into a stage-2 train step
    (TRAIN.gt_in_step="on"; counterpart of gator_tpu/train/loop.py:253).

    The step takes raw batches (`SmplPoseDataset.make_raw_batch`): the
    SMPL and camera parameters in place of the [B, V, 3] mesh target, which
    the step synthesises with its fit-validity mask on the synthesizer's
    device, with the host path's math (GtSynthesizer.smpl_mesh_cam and
    fitting_error; reference: Human36M/dataset.py:254-309). The batch is
    ~100 host floats a sample and no device tensor waits in the prefetch
    queue. The assembly is `step.assemble(state, batch, seed, ...)`."""
    from ..data.device_pipeline import with_assembly
    from ..data.gt_synth import (fit_valid_mask_fn, fitting_error_fn,
                                 mesh_cam_fn)

    def assemble(state, batch: Batch, *extra) -> Batch:
        no_tf32()
        b = {k: _on(v, synth.device) for k, v in batch.items()}
        inner = {k: v for k, v in b.items() if k not in _RAW_BATCH_KEYS}
        with span("step.gt"):
            mesh_mm, _ = mesh_cam_fn(
                synth.params[gender], synth.mean_betas[gender],
                b["smpl_pose"], b["smpl_shape"], b["smpl_trans"],
                b["cam_r"], b["cam_t"])
            inner["mesh"] = ((mesh_mm - b["mesh_root_mm"]) / 1000.0).float()
            # the fit-gate target is reg_pose3d (the root-relative h36m
            # joints, not augmented on this path)
            fit = fitting_error_fn(synth.j_reg_h36m, inner["reg_pose3d"],
                                   mesh_mm)
            inner["mesh_valid"] = fit_valid_mask_fn(fit, fitting_thr)
        inner["lift_valid"] = torch.ones_like(inner["mesh_valid"])
        inner["reg_valid"] = torch.ones_like(inner["mesh_valid"])
        return inner

    return with_assembly(step_fn, assemble)


def _sample0(batch: Batch, world) -> int:
    """The global index of this rank's first sample."""
    return 0 if world is None else world.rank * batch["pose2d"].shape[0]


def _on(x, device) -> torch.Tensor:
    """A batch leaf (host array or tensor) as f32 on `device`."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _batch_on(batch: Batch, model: torch.nn.Module) -> Batch:
    """Every leaf of a batch (host arrays from `data.BatchPipeline`, or
    tensors) as f32 on the model's device; a leaf already there is not
    copied."""
    dev = next(model.parameters()).device
    return {k: _on(v, dev) for k, v in batch.items()}
