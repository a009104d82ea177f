"""GAT — graph-aware transformer pose lifter (2D pose -> 3D pose + features),
module form (counterpart of gator_tpu.models.gat; reference:
lib/models/GAT.py:16-156).

Each block is `x + XFeat(Attn(LN x, bias) + MGCN(LN x))` then
`x + MLP(LN x)`; at inference dropout and drop-path are identity. The
attribute names mirror the reference's state-dict keys
(`pose_lifter.blocks.0.attn.qkv.weight`, ...).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..assets.bundle import GatorAssets
from ..nn import MGCN, BiasAttention, GraphLinear, HopPathEncoding, Mlp, XFeat


@dataclasses.dataclass(frozen=True, eq=False)
class GatSpec:
    """Hyperparameters and graph tables of one GAT instance."""

    num_joint: int
    embed_dim: int = 128
    depth: int = 6
    num_heads: int = 8
    mlp_ratio: float = 4.0
    drop_rate: float = 0.4          # BiasAttention proj dropout (training)
    attn_drop_rate: float = 0.4     # BiasAttention prob dropout (training)
    drop_path_rate: float = 0.2     # DropPath, linspace over the blocks
    num_spatial: int = 10
    adjacency: np.ndarray = None
    degree: np.ndarray = None
    spatial_pos: np.ndarray = None
    edge_input: np.ndarray = None
    hop_recip: np.ndarray = None
    masks_xfeat: np.ndarray = None

    @classmethod
    def from_assets(cls, assets: GatorAssets, embed_dim=128, depth=6,
                    **kw) -> "GatSpec":
        g = assets.graph
        return cls(num_joint=assets.joint_num, embed_dim=embed_dim,
                   depth=depth, adjacency=g.adjacency, degree=g.degree,
                   spatial_pos=g.spatial_pos, edge_input=g.edge_input,
                   hop_recip=g.hop_recip, masks_xfeat=g.masks_xfeat, **kw)


def pinned(table: torch.Tensor) -> torch.Tensor:
    """An embedding table with row 0 zeroed (torch padding_idx=0)."""
    table = table.clone()
    table[0] = 0.0
    return table


class GATBlock(nn.Module):
    """One lifter block (reference: lib/models/GAT.py:16-43)."""

    def __init__(self, spec: GatSpec):
        super().__init__()
        c = spec.embed_dim
        self.norm1 = nn.LayerNorm(c, eps=1e-5)
        self.attn = BiasAttention(c, spec.num_heads)
        self.gcn = MGCN(c, c, spec.adjacency)
        self.x_feat = XFeat(c, spec.masks_xfeat)
        self.norm2 = nn.LayerNorm(c, eps=1e-5)
        self.mlp = Mlp(c, int(c * spec.mlp_ratio), c)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        x = x + self.x_feat(self.attn(y, bias) + self.gcn(y))
        return x + self.mlp(self.norm2(x))


class GAT(nn.Module):
    """Full lifter: pose2d [B, J*2] or [B, J, 2] -> (pose3d [B, 3*J],
    features [B, J, C])."""

    def __init__(self, spec: GatSpec):
        super().__init__()
        self.spec = spec
        j, c = spec.num_joint, spec.embed_dim
        # input embed over the channel-major layout: GraphLinear,
        # GroupNormCF (torch's GroupNorm), GELU (index 2), GraphLinear
        # (reference: lib/models/GAT.py:69-72)
        self.GLinear = nn.Sequential(GraphLinear(2, 64),
                                     nn.GroupNorm(64 // 16, 64, eps=1e-5),
                                     nn.GELU(), GraphLinear(64, c))
        self.pos_id_embed = nn.Embedding(j + 1, c, padding_idx=0)
        self.pos_num_embed = nn.Embedding(j, c, padding_idx=0)
        self.get_hop_path_encoding = HopPathEncoding(
            spec.num_heads, spec.num_spatial, spec.spatial_pos,
            spec.edge_input, spec.hop_recip)
        self.blocks = nn.ModuleList([GATBlock(spec)
                                     for _ in range(spec.depth)])
        self.norm = nn.LayerNorm(c, eps=1e-5)
        self.lifter = nn.Linear(j * c, 3 * j)
        self.register_buffer("degree", torch.as_tensor(
            np.asarray(spec.degree), dtype=torch.long), persistent=False)

    def embed(self, pose2d: torch.Tensor) -> torch.Tensor:
        """pose2d -> tokens [B, J, C] before the first block."""
        b = pose2d.shape[0]
        j = self.spec.num_joint
        x = self.GLinear(pose2d.reshape(b, j, 2).transpose(1, 2))
        x = x.transpose(1, 2)
        ids = torch.arange(1, j + 1, device=x.device)
        x = x + pinned(self.pos_id_embed.weight)[ids]
        return x + pinned(self.pos_num_embed.weight)[self.degree]

    def forward(self, pose2d: torch.Tensor):
        x = self.embed(pose2d)
        bias = self.get_hop_path_encoding()
        for blk in self.blocks:
            x = blk(x, bias)
        x = F.gelu(self.norm(x))
        return self.lifter(x.reshape(x.shape[0], -1)), x
