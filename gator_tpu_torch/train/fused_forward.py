"""The training forward of GATOR with both hot stacks on the training
kernels (counterpart of gator_tpu/train/fused_forward.py): the GAT trunk on
K5 (`nn.gat_trunk_train`) and the MDR LBF stack on K4
(`nn.lbf_stack_train`), everything around them plain, differentiable torch.

Weights are the module's f32 masters, cast to the compute dtype inside the
graph on every call; the hop/path bias is computed from its parameters on
every call. The MDR head's BatchNorm runs in train mode written out by hand
as the JAX package does (gator_tpu/train/fused_forward.py:99-117): batch
statistics over (batch, coord) per vertex channel, the biased batch
variance both in the normalisation and in the running-stat update, running
stats updated with momentum 0.9 in flax form (new = 0.9 old + 0.1 batch);
`nn.BatchNorm1d`'s own train mode (unbiased running variance) is not used.

With all rates zero this forward equals the JAX fused forward at zero rates
(tests/test_torch_training.py).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..models.gat import pinned
from ..models.mdr import conv1d_len3
from ..nn.gat_trunk_train import (extract_block_params, gat_trunk_train,
                                  gat_trunk_train_ref)
from ..nn.layers import layer_norm32
from ..nn.lbf_stack_train import (extract_layer_params, lbf_stack_train,
                                  lbf_stack_train_ref)

Trunk = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, list],
                 torch.Tensor]


def rates_from_spec(mdr_spec) -> tuple:
    """LBF dropout rates for an MdrSpec (gator_tpu/train/fused_forward.py
    :31): the cross-attention block's 0.2s are model constants, the
    self-attention and its residual follow spec.dropout."""
    d = mdr_spec.dropout
    return (0.2, 0.2, 0.2, 0.2, d, d)


def gat_trunk_fn(spec, seed: int, use_kernels: bool = True,
                 mlp_rate: float = 0.1) -> Trunk:
    """-> trunk(x, bias, masks_xfeat, block_params) on K5 (or its plain
    version) with the spec's attention/projection/DropPath rates and
    GatMlp's `mlp_rate` (fixed 0.1 in the reference)."""
    fn = gat_trunk_train if use_kernels else gat_trunk_train_ref

    def trunk(x, bias, masks_xfeat, block_params):
        return fn(x, bias, block_params, masks_xfeat, spec.num_heads,
                  seed, attn_rate=spec.attn_drop_rate,
                  proj_rate=spec.drop_rate, mlp_rate=mlp_rate,
                  drop_path_rate=spec.drop_path_rate)

    return trunk


def gat_train_forward(gat, pose2d: torch.Tensor, dtype: torch.dtype,
                      trunk: Trunk) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GAT forward of gator_tpu/serving.py:33 `gat_serving_forward`
    with a `trunk` hook, differentiable in every parameter of the `GAT`
    module -> (pose3d [B, 3J], features [B, J, C])."""
    s = gat.spec
    b = pose2d.shape[0]
    x = pose2d.reshape(b, s.num_joint, 2).to(dtype).transpose(1, 2)
    g0, gn, g3 = gat.GLinear[0], gat.GLinear[1], gat.GLinear[3]
    x = torch.einsum("oi,bij->boj", g0.W.to(dtype), x) \
        + g0.b.to(dtype)[None, :, None]
    # GroupNorm(4, 64) in f32 over (C/G)*J
    x32 = x.float().reshape(b, 4, -1)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    x32 = ((x32 - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape)
    x = (x32 * gn.weight[None, :, None] + gn.bias[None, :, None]).to(dtype)
    x = F.gelu(x)
    x = torch.einsum("oi,bij->boj", g3.W.to(dtype), x) \
        + g3.b.to(dtype)[None, :, None]
    x = x.transpose(1, 2)
    x = x + pinned(gat.pos_id_embed.weight)[1:s.num_joint + 1].to(dtype)
    x = x + pinned(gat.pos_num_embed.weight)[gat.degree].to(dtype)
    bias = gat.get_hop_path_encoding().float()
    # the XFeat masks as the module holds them, on its device
    x = trunk(x.contiguous(), bias, gat.blocks[0].x_feat.masks,
              [extract_block_params(blk) for blk in gat.blocks])
    feat = F.gelu(layer_norm32(x, gat.norm.weight, gat.norm.bias).to(dtype))
    pose3d = feat.reshape(b, -1) @ gat.lifter.weight.T.to(dtype) \
        + gat.lifter.bias.to(dtype)
    return pose3d, feat


def _dense(mod, y: torch.Tensor, dtype) -> torch.Tensor:
    return y @ mod.weight.T.to(dtype) + mod.bias.to(dtype)


def mdr_train_forward(mdr, x: torch.Tensor, seed: int,
                      dtype: torch.dtype = torch.bfloat16, rates=None,
                      use_kernels: bool = True):
    """MDR in train mode (gator_tpu/train/fused_forward.py:46) -> (mesh
    [B, V0, 3], new BatchNorm running stats (mean, var) or None for the
    LayerNorm head). The running stats are returned, not written."""
    s = mdr.spec
    if rates is None:
        rates = rates_from_spec(s)
    b = x.shape[0]
    x = x.to(dtype)
    verts = torch.cat([mdr.init_verts_coarse.to(dtype)[None].expand(
        b, -1, -1), x[:, mdr.vj_relation, 2:5]], dim=2)
    joint_feat = _dense(mdr.get_joint_feature, x, dtype) \
        + mdr.pos_j_id_embed.weight[1:s.num_joint + 1].to(dtype)
    verts_feat = _dense(mdr.get_verts_feature, verts, dtype) \
        + mdr.pos_v_id_embed.weight[1:s.coarse_num + 1].to(dtype)
    stack = lbf_stack_train if use_kernels else lbf_stack_train_ref
    verts_feat = stack(verts_feat.contiguous(), joint_feat.contiguous(),
                       [extract_layer_params(mdr, i) for i in range(3)],
                       s.num_heads, seed, rates=rates)

    ac = _dense(mdr.motion_linear, verts_feat, dtype)
    mat_a, mat_c = ac[:, :, :s.num_basis], ac[:, :, -3:]
    m32 = _dense(mdr.bias_linear, verts_feat, dtype).float()
    bn = mdr.bias_norm
    new_stats = None
    if s.alpha:
        mean = m32.mean(-1, keepdim=True)
        var = ((m32 - mean) ** 2).mean(-1, keepdim=True)
        mat_b = ((m32 - mean) * torch.rsqrt(var + 1e-5) * bn.weight
                 + bn.bias).to(dtype)
    else:
        bmean = m32.mean(dim=(0, 2))
        bvar = ((m32 - bmean[None, :, None]) ** 2).mean(dim=(0, 2))
        norm = (m32 - bmean[None, :, None]) \
            * torch.rsqrt(bvar[None, :, None] + 1e-5)
        mat_b = (norm * bn.weight[None, :, None]
                 + bn.bias[None, :, None]).to(dtype)
        new_stats = (0.9 * bn.running_mean + 0.1 * bmean.detach(),
                     0.9 * bn.running_var + 0.1 * bvar.detach())
    mat_b = conv1d_len3(F.gelu(mat_b), mdr.bias_conv1d.weight.to(dtype),
                        mdr.bias_conv1d.bias.to(dtype))
    if s.alpha:
        alpha = torch.pow(torch.tensor(1.1, dtype=dtype, device=x.device),
                          _dense(mdr.scale_linear, verts_feat, dtype))
    else:
        alpha = 1.0
    attn_a = torch.softmax(mat_a.float(), dim=-1).to(dtype)
    vert = alpha * torch.einsum("bvk,bkc->bvc", attn_a, mat_b) + mat_c
    vert = conv1d_len3(vert, mdr.upsample_conv.weight.to(dtype),
                       mdr.upsample_conv.bias.to(dtype))
    return vert + mdr.init_verts_full.to(dtype), new_stats


def make_fused_forward(spec, dtype: torch.dtype = torch.bfloat16,
                       rates=None, use_kernels: bool = True,
                       gat_mlp_rate: float = 0.1):
    """-> fwd(model, pose2d, seed) -> (mesh, pose3d, new BatchNorm stats
    or None), the counterpart of gator_tpu/train/fused_forward.py:134 with
    both stacks on the training kernels (`use_kernels=False`: their plain
    versions, on any device). `rates`: the LBF rates (default from the
    spec); the GAT's come from the spec, GatMlp's is `gat_mlp_rate`."""
    s = spec

    def fwd(model, pose2d: torch.Tensor, seed: int):
        b = pose2d.shape[0]
        pose2d = pose2d.reshape(b, s.gat.num_joint, 2).to(dtype)
        trunk = gat_trunk_fn(s.gat, seed, use_kernels, gat_mlp_rate)
        pose3d_flat, feat = gat_train_forward(model.pose_lifter, pose2d,
                                              dtype, trunk)
        pose3d = pose3d_flat.reshape(b, s.gat.num_joint, 3)
        pose_combine = torch.cat([pose2d, pose3d.to(dtype) / 1000.0,
                                  feat.to(dtype)], dim=2)
        mesh, new_stats = mdr_train_forward(model.pose2mesh, pose_combine,
                                            seed, dtype, rates, use_kernels)
        return mesh, pose3d, new_stats

    return fwd

