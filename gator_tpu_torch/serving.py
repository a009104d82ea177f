"""Serving path: pose [B, J, 2] -> (mesh [B, V0, 3], pose3d [B, J, 3]).

Counterpart of gator_tpu/serving.py:164 `make_serving_fn`. The function it
returns computes what `GATOR.forward` computes, with the two hot stacks on
the hand-written kernels when the model lives on a CUDA device:
  * the GAT trunk on K1 (`nn.gat_trunk`, csrc/gat_trunk.cu);
  * the MDR LBF stack on K2 (`nn.lbf_stack`, csrc/lbf_stack.cu).
On a CPU model the same code runs the kernels' plain versions. The embeds,
the hop/path bias, the A/B/C head and the 431->6890 upsample are plain
torch, as they are XLA code (not Pallas) in the JAX package.
`make_sharded_serving_fn` serves a batch over the data-parallel ranks.

The same two functions serve any model that brings its own fold and
forward (`serving_fold(dtype, use_kernels)` -> (w, consts) and
`serving_forward(w, consts, x, dtype)`; `own_serving_fn`): MotionBERT's
mesh model (`models.motionbert.MeshRegressor`: clips [B, T, 17, 3] ->
(verts [B, T, V0, 3], kp3d [B, T, 17, 3]), the batch axis counting
clips) and HMR 2.0 (`models.hmr2.HMR2`: crops [B, 3, 256, 256] -> (verts
[B, V0, 3], joints [B, 24, 3], cam_t [B, 3])), every attention of both on
K3.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from .models.gat import pinned
from .models.gator import GATOR
from .models.mdr import conv1d_len3
from .nn import (fold_stack_weights, fold_trunk_weights, gat_trunk,
                 gat_trunk_ref, lbf_stack, lbf_stack_ref, layer_norm32)
from .nn.gat_trunk import check_width
from .parallel import all_gather_rows, local_rows
from .profiling import span

ServingFn = Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]


def gat_serving_forward(model: GATOR, w: Dict[str, torch.Tensor], consts,
                        pose2d: torch.Tensor, dtype: torch.dtype):
    """GAT forward (gator_tpu/serving.py:33) -> (pose3d [B, 3J],
    features [B, J, C]), in the spans serve.gat_embed, serve.k1 and
    serve.gat_head."""
    s = model.spec.gat
    b = pose2d.shape[0]
    p = "pose_lifter."
    with span("serve.gat_embed"):
        x = pose2d.reshape(b, s.num_joint, 2).to(dtype).transpose(1, 2)
        x = torch.einsum("oi,bij->boj", w[p + "GLinear.0.W"], x) \
            + w[p + "GLinear.0.b"][None, :, None]
        # GroupNorm(4, 64) in f32 over (C/G)*J
        x32 = x.float().reshape(b, 4, -1)
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
        x32 = ((x32 - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape)
        x = (x32 * w[p + "GLinear.1.weight"].float()[None, :, None]
             + w[p + "GLinear.1.bias"].float()[None, :, None]).to(dtype)
        x = F.gelu(x)
        x = torch.einsum("oi,bij->boj", w[p + "GLinear.3.W"], x) \
            + w[p + "GLinear.3.b"][None, :, None]
        x = x.transpose(1, 2) + consts["pos_id"]
        x = (x + consts["pos_num"]).contiguous()

    with span("serve.k1"):
        x = consts["trunk_fn"](x, consts["hop_bias"], consts["masks"],
                               consts["trunk"], s.num_heads)

    with span("serve.gat_head"):
        feat = F.gelu(layer_norm32(x, w[p + "norm.weight"],
                                 w[p + "norm.bias"]).to(dtype))
        pose3d = feat.reshape(b, -1) @ w[p + "lifter.weight"].T \
            + w[p + "lifter.bias"]
    return pose3d, feat


def mdr_serving_forward(model: GATOR, w: Dict[str, torch.Tensor], consts,
                        x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """MDR forward (gator_tpu/serving.py:100) -> mesh [B, V0, 3], in the
    spans serve.mdr_tokens, serve.k2, serve.head and serve.upsample."""
    mdr = model.pose2mesh
    s = mdr.spec
    b = x.shape[0]
    p = "pose2mesh."

    def dense(name, y):
        return y @ w[p + name + ".weight"].T + w[p + name + ".bias"]

    with span("serve.mdr_tokens"):
        x = x.to(dtype)
        verts = torch.cat([consts["init_coarse"][None].expand(b, -1, -1),
                           x[:, mdr.vj_relation, 2:5]], dim=2)
        joint_feat = dense("get_joint_feature", x) + consts["pos_j"]
        verts_feat = dense("get_verts_feature", verts) + consts["pos_v"]

    with span("serve.k2"):
        verts_feat = consts["stack_fn"](verts_feat.contiguous(),
                                        joint_feat.contiguous(),
                                        consts["stack"], s.num_heads)

    with span("serve.head"):
        ac = dense("motion_linear", verts_feat)
        mat_a, mat_c = ac[:, :, :s.num_basis], ac[:, :, -3:]
        mat_b = dense("bias_linear", verts_feat)
        bn = p + "bias_norm."
        if s.alpha:
            mat_b = layer_norm32(mat_b, w[bn + "weight"], w[bn + "bias"])
        else:
            # running stats stay f32 whatever the serving dtype
            mat_b = ((mat_b.float() - w[bn + "running_mean"][None, :, None])
                     * torch.rsqrt(w[bn + "running_var"][None, :, None]
                                   + 1e-5)
                     * w[bn + "weight"].float()[None, :, None]
                     + w[bn + "bias"].float()[None, :, None])
        mat_b = F.gelu(mat_b.to(dtype))
        mat_b = conv1d_len3(mat_b, w[p + "bias_conv1d.weight"],
                            w[p + "bias_conv1d.bias"])
        if s.alpha:
            alpha = torch.pow(torch.tensor(1.1, dtype=dtype,
                                           device=x.device),
                              dense("scale_linear", verts_feat))
        else:
            alpha = 1.0
        attn_a = torch.softmax(mat_a.float(), dim=-1).to(dtype)
        vert = alpha * torch.einsum("bvk,bkc->bvc", attn_a, mat_b) + mat_c

    with span("serve.upsample"):
        vert = conv1d_len3(vert, w[p + "upsample_conv.weight"],
                           w[p + "upsample_conv.bias"])
        return vert + consts["init_full"]


def serving_weights(model: GATOR, dtype: torch.dtype,
                    use_kernels: bool = True):
    """-> (w, consts) for `gat_serving_forward` and `mdr_serving_forward`:
    the state dict cast to `dtype` once (BatchNorm running stats stay f32),
    and the kernels' packed weights, the stage functions (the kernels, or
    with `use_kernels=False` their plain versions) and the input-independent
    tables (hop/path bias, position embeddings), in the set-up span
    setup.fold."""
    spec = model.spec
    gat, mdr = model.pose_lifter, model.pose2mesh
    device = next(model.parameters()).device
    if use_kernels and device.type == "cuda":
        check_width(spec.gat.embed_dim, spec.gat.num_heads)
    with torch.no_grad(), span("setup.fold", always=True):
        w = {k: v if ("running_" in k or not v.is_floating_point())
             else v.to(dtype) for k, v in model.state_dict().items()}
        j = spec.gat.num_joint
        consts = {
            "trunk_fn": gat_trunk if use_kernels else gat_trunk_ref,
            "stack_fn": lbf_stack if use_kernels else lbf_stack_ref,
            "hop_bias": gat.get_hop_path_encoding().float(),
            "masks": gat.blocks[0].x_feat.masks.float(),
            "trunk": fold_trunk_weights(gat.blocks, dtype, device),
            "stack": fold_stack_weights(mdr, dtype, device),
            "pos_id": w["pose_lifter.pos_id_embed.weight"][1:j + 1],
            "pos_num": pinned(w["pose_lifter.pos_num_embed.weight"])[
                gat.degree],
            "pos_j": w["pose2mesh.pos_j_id_embed.weight"][1:j + 1],
            "pos_v": w["pose2mesh.pos_v_id_embed.weight"][
                1:spec.mdr.coarse_num + 1],
            "init_coarse": mdr.init_verts_coarse.to(dtype),
            "init_full": mdr.init_verts_full.to(dtype),
        }
    return w, consts


def make_serving_fn(model, dtype: torch.dtype = torch.bfloat16,
                    use_kernels: bool = True) -> ServingFn:
    """-> fn(pose2d [B, J, 2]) -> (mesh [B, V0, 3], pose3d [B, J, 3]), on
    the model's device, without gradients; for a model that brings its own
    fold and forward (MotionBERT's, HMR 2.0), its forward's function
    (`own_serving_fn`).

    `use_kernels=False` runs the kernels' plain versions on any device:
    the on-card numerics oracle of tests/test_torch_paths_cuda.py and the
    speed baseline of tools/profile_trunk.py, as `use_fused=False` is in
    the JAX package. The weights and tables are
    derived once, by `serving_weights`. A call is the span `serve`, its
    stages the spans of the two forward functions."""
    if hasattr(model, "serving_forward"):
        return own_serving_fn(model, dtype, use_kernels)
    j = model.spec.gat.num_joint
    device = next(model.parameters()).device
    w, consts = serving_weights(model, dtype, use_kernels)

    @torch.no_grad()
    def serve(pose2d: torch.Tensor):
        with span("serve"):
            b = pose2d.shape[0]
            pose2d = pose2d.reshape(b, j, 2).to(device=device, dtype=dtype)
            pose3d_flat, feat = gat_serving_forward(model, w, consts,
                                                    pose2d, dtype)
            pose3d = pose3d_flat.reshape(b, j, 3)
            pose_combine = torch.cat([pose2d, pose3d / 1000.0, feat], dim=2)
            mesh = mdr_serving_forward(model, w, consts, pose_combine, dtype)
            return mesh, pose3d

    return serve


def own_serving_fn(model, dtype: torch.dtype = torch.bfloat16,
                   use_kernels: bool = True) -> ServingFn:
    """The serving call of a model that brings its own fold and forward:
    fn(x) -> the outputs of `model.serving_forward`, f32, on the model's
    device, without gradients; products in `dtype`, the attentions on K3
    (its plain version with `use_kernels=False`). The weights are derived
    once (`model.serving_fold`). A call is the span `serve`, its stages
    the spans of the model's forward (models/motionbert.py `mesh_forward`,
    models/hmr2.py `hmr2_forward`)."""
    device = next(model.parameters()).device
    w, consts = model.serving_fold(dtype, use_kernels)

    @torch.no_grad()
    def serve(x: torch.Tensor):
        with span("serve"):
            return model.serving_forward(w, consts, x.to(device=device),
                                         dtype)

    return serve


def make_sharded_serving_fn(model: GATOR, world,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> ServingFn:
    """Data-parallel serving (counterpart of gator_tpu/serving.py:218): on
    every rank, fn(pose2d [B, J, 2]) -> (mesh [B, V0, 3], pose3d [B, J,
    3]) of the whole batch. Each rank serves its rows [r*b, (r+1)*b) on K1
    and K2 (`make_serving_fn` over its replica of the model) and the mesh
    and pose rows are all-gathered back in row order. B must be a multiple
    of the world size; pad a ragged batch with `parallel.pad_to_multiple`.
    MotionBERT's mesh model and HMR 2.0 are served the same way, their rows
    clips and crops, each of their outputs gathered.
    """
    serve_rows = make_serving_fn(model, dtype=dtype)

    @torch.no_grad()
    def serve(pose2d: torch.Tensor):
        return tuple(all_gather_rows(out, world)
                     for out in serve_rows(local_rows(pose2d, world)))

    return serve
