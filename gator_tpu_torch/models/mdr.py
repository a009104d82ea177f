"""MDR — motion-disentangled regression head (joints -> mesh vertices),
module form (counterpart of gator_tpu.models.mdr; reference:
lib/models/MDR.py:71-174):
  * vertex tokens = coarse template vertices + lifted-3D coords of each
    vertex's nearest joint;
  * 3x (joint->vertex cross-attention block + std-LayerNorm + vertex
    self-attention with a residual on the normalised tokens);
  * head: A [V2, 20] / C [V2, 3] from `motion_linear`, motion basis
    B = Conv1d(V2 -> 20, k=3) over the 3-wide coordinate axis,
    vert = alpha * softmax(A) @ B + C, then Conv1d(V2 -> V0) + template.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..assets.bundle import GatorAssets
from ..nn import CrossAttention, Mlp, MultiHeadedAttention, StdLayerNorm
from .gat import pinned


@dataclasses.dataclass(frozen=True, eq=False)
class MdrSpec:
    num_joint: int
    gat_dim: int = 128           # feature width arriving from GAT
    embed_dim: int = 64          # internal width (reference: MDR.py:74)
    num_heads: int = 2
    num_basis: int = 20          # motion-basis size
    alpha: bool = False          # learned scale + LayerNorm vs BatchNorm
    dropout: float = 0.1         # self-attention and its residual (training)
    init_verts_coarse: np.ndarray = None    # [V2, 3]
    init_verts_full: np.ndarray = None      # [V0, 3]
    vj_relation: np.ndarray = None          # [V2] nearest-joint indices

    @classmethod
    def from_assets(cls, assets: GatorAssets, gat_dim=128,
                    alpha=False) -> "MdrSpec":
        return cls(num_joint=assets.joint_num, gat_dim=gat_dim, alpha=alpha,
                   init_verts_coarse=assets.init_verts_coarse,
                   init_verts_full=assets.mean_vertices,
                   vj_relation=assets.vj_relation)

    @property
    def coarse_num(self) -> int:
        return self.init_verts_coarse.shape[0]

    @property
    def full_num(self) -> int:
        return self.init_verts_full.shape[0]


def conv1d_len3(x: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """torch Conv1d(C_in -> C_out, kernel=3, padding=1) on [B, C_in, 3],
    written as three shifted matmuls over the channel axis. F.conv1d is not
    used: cuDNN runs it in TF32 by default. kernel: [C_out, C_in, 3];
    returns [B, C_out, 3]."""
    pad = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    shifted = (
        torch.cat([pad, x[..., :-1]], dim=-1),   # tap k=0 reads l-1
        x,                                       # tap k=1 reads l
        torch.cat([x[..., 1:], pad], dim=-1),    # tap k=2 reads l+1
    )
    out = bias[None, :, None]
    for k in range(3):
        out = out + torch.einsum("bcl,oc->bol", shifted[k], kernel[:, :, k])
    return out


class Conv1dLen3(nn.Module):
    """Parameters of a torch Conv1d(k=3) applied by `conv1d_len3`."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_len3(x, self.weight, self.bias)


class CrossAttentionBlock(nn.Module):
    """Pre-norm cross-attention + MLP over the vertex tokens
    (reference: lib/models/MDR.py:48-69)."""

    def __init__(self, dim: int, joint_num: int, num_heads: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = CrossAttention(dim, joint_num, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nv = x.shape[1] - self.attn.joint_num
        x = x[:, :nv] + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class MDR(nn.Module):
    """Head: [B, J, 2+3+gat_dim] joint tokens -> [B, V0, 3] mesh."""

    def __init__(self, spec: MdrSpec):
        super().__init__()
        self.spec = spec
        s = spec
        c, v2 = s.embed_dim, s.coarse_num
        self.get_joint_feature = nn.Linear(2 + 3 + s.gat_dim, c)
        self.get_verts_feature = nn.Linear(6, c)
        self.pos_j_id_embed = nn.Embedding(s.num_joint + 1, c, padding_idx=0)
        self.pos_v_id_embed = nn.Embedding(v2 + 1, c, padding_idx=0)
        for sfx in ("", "_1", "_2"):
            self.add_module(f"encoder{sfx}", CrossAttentionBlock(
                c, s.num_joint, s.num_heads))
            self.add_module(f"norm{sfx}", StdLayerNorm(c))
            self.add_module(f"selfatt{sfx}", MultiHeadedAttention(
                s.num_heads, c))
        self.motion_linear = nn.Linear(c, s.num_basis + 3)
        self.bias_linear = nn.Linear(c, 3)
        # BatchNorm1d(V2) over [B, V2, 3], or LayerNorm over the 3 coords
        # (reference: lib/models/MDR.py:119,159)
        self.bias_norm = (nn.LayerNorm(3, eps=1e-5) if s.alpha
                          else nn.BatchNorm1d(v2, eps=1e-5))
        self.bias_conv1d = Conv1dLen3(v2, s.num_basis)
        if s.alpha:
            self.scale_linear = nn.Linear(c, 1)
        self.upsample_conv = Conv1dLen3(v2, s.full_num)
        for name, arr, dt in (
                ("init_verts_coarse", s.init_verts_coarse, torch.float32),
                ("init_verts_full", s.init_verts_full, torch.float32),
                ("vj_relation", s.vj_relation, torch.long)):
            self.register_buffer(name, torch.as_tensor(np.asarray(arr),
                                                       dtype=dt),
                                 persistent=False)

    def lbf_layers(self):
        """[(encoder, norm, selfatt)] for the three LBF layers."""
        return [(getattr(self, f"encoder{sfx}"), getattr(self, f"norm{sfx}"),
                 getattr(self, f"selfatt{sfx}")) for sfx in ("", "_1", "_2")]

    def tokens(self, x: torch.Tensor):
        """Token build (reference: lib/models/MDR.py:126-137):
        -> (vertex tokens [B, V2, C], joint tokens [B, J, C])."""
        s = self.spec
        b = x.shape[0]
        verts = torch.cat([self.init_verts_coarse.to(x.dtype)[None].expand(
            b, -1, -1), x[:, self.vj_relation, 2:5]], dim=2)
        joint_feat = self.get_joint_feature(x)
        verts_feat = self.get_verts_feature(verts)
        joint_feat = joint_feat + pinned(self.pos_j_id_embed.weight)[
            1:s.num_joint + 1]
        verts_feat = verts_feat + pinned(self.pos_v_id_embed.weight)[
            1:s.coarse_num + 1]
        return verts_feat, joint_feat

    def forward(self, x: torch.Tensor, use_kernels: bool = True
                ) -> torch.Tensor:
        """use_kernels=False keeps the vertex self-attention off K3."""
        s = self.spec
        verts_feat, joint_feat = self.tokens(x)
        for enc, norm, sa in self.lbf_layers():
            verts_feat = enc(torch.cat([verts_feat, joint_feat], dim=1))
            verts_feat = norm(verts_feat)
            verts_feat = verts_feat + sa(verts_feat, verts_feat, verts_feat,
                                         use_kernel=use_kernels)

        ac = self.motion_linear(verts_feat)
        mat_a, mat_c = ac[:, :, :s.num_basis], ac[:, :, -3:]
        mat_b = self.bias_linear(verts_feat)
        if s.alpha:
            mat_b = self.bias_norm(mat_b)
        else:
            bn = self.bias_norm
            mat_b = F.batch_norm(mat_b, bn.running_mean, bn.running_var,
                                 bn.weight, bn.bias, False, 0.0, bn.eps)
        mat_b = self.bias_conv1d(F.gelu(mat_b))             # [B, 20, 3]
        alpha = (torch.pow(1.1, self.scale_linear(verts_feat)) if s.alpha
                 else 1.0)
        attn_a = torch.softmax(mat_a.float(), dim=-1).to(mat_a.dtype)
        vert = alpha * torch.einsum("bvk,bkc->bvc", attn_a, mat_b) + mat_c
        return self.upsample_conv(vert) + self.init_verts_full
