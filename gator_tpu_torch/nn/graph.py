"""Graph-structured layers: modulated graph conv (MGCN), hop-masked
multi-scale aggregation (XFeat), and the hop/path attention-bias encoder
(counterpart of gator_tpu.nn.graph).

The graph structure arrives as precomputed numpy tables
(`gator_tpu_torch.assets.graphs.GraphTables`), held as non-persistent
buffers so that they follow the module's device and stay out of the state
dict.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _buffer(module: nn.Module, name: str, array, dtype=torch.float32):
    module.register_buffer(name, torch.as_tensor(np.asarray(array),
                                                 dtype=dtype),
                           persistent=False)


def symmetric_adjacency(adjacency: torch.Tensor,
                        adj2: torch.Tensor) -> torch.Tensor:
    """adj = (A + adj2), symmetrised as (adjᵀ + adj) / 2
    (reference: lib/models/backbones/modules.py:243-249)."""
    adj = adjacency + adj2
    return (adj.T + adj) / 2


class MGCN(nn.Module):
    """Modulated graph convolution: separate self/neighbour weights,
    per-node modulation M, learned adjacency residual adj2, symmetrised
    (reference: lib/models/backbones/modules.py:213-255)."""

    def __init__(self, in_features: int, features: int,
                 adjacency: np.ndarray):
        super().__init__()
        j = adjacency.shape[0]
        self.W = nn.Parameter(torch.empty(2, in_features, features))
        self.M = nn.Parameter(torch.empty(j, features))
        self.adj2 = nn.Parameter(torch.empty(j, j))
        self.bias = nn.Parameter(torch.empty(features))
        _buffer(self, "adjacency", adjacency)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = x @ self.W[0]
        h1 = x @ self.W[1]
        adj = symmetric_adjacency(self.adjacency, self.adj2)
        eye = torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device)
        out = torch.einsum("ij,bjo->bio", adj * eye, self.M * h0) \
            + torch.einsum("ij,bjo->bio", adj * (1 - eye), self.M * h1)
        return out + self.bias


class XFeat(nn.Module):
    """Hop-masked multi-scale aggregation: per-hop-ring linear (channel
    shrink by 8 for the 2-ring), masked sum over the ring, concat, project
    back (reference: lib/models/backbones/modules.py:140-177, s=1, l=2)."""

    def __init__(self, dim: int, masks: np.ndarray, shrink: int = 8):
        super().__init__()
        widths = [dim // shrink ** ring for ring in range(masks.shape[0])]
        self.linears = nn.ModuleList([nn.Linear(dim, w) for w in widths])
        self.linearback = nn.Linear(sum(widths), dim)
        _buffer(self, "masks", masks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [torch.einsum("ij,bjc->bic", mask, lin(x))
                 for lin, mask in zip(self.linears, self.masks)]
        return self.linearback(torch.cat(feats, dim=-1))


class HopPathEncoding(nn.Module):
    """Per-head [H, J, J] attention bias: hop-distance embedding + learned
    weighting of per-hop bone-length path features scaled by 1/(hops-1)
    (reference: lib/models/backbones/modules.py:77-107)."""

    def __init__(self, num_heads: int, num_spatial: int,
                 spatial_pos: np.ndarray, edge_input: np.ndarray,
                 hop_recip: np.ndarray):
        super().__init__()
        j = spatial_pos.shape[0]
        d = edge_input.shape[-1]
        self.num_heads = num_heads
        self.spatial_pos_encoder = nn.Embedding(num_spatial, num_heads,
                                                padding_idx=0)
        self.edge_encoder = nn.Linear(j * j, j * j * num_heads)
        self.W = nn.Parameter(torch.ones(num_heads, j, j, d))
        _buffer(self, "spatial_pos", spatial_pos, torch.long)
        _buffer(self, "edge_input", edge_input)
        _buffer(self, "hop_recip", hop_recip)

    def forward(self) -> torch.Tensor:
        j = self.spatial_pos.shape[0]
        d = self.edge_input.shape[-1]
        h = self.num_heads
        # row 0 (hop 0, the diagonal) is pinned to zero, as padding_idx=0
        # keeps it in the reference
        table = self.spatial_pos_encoder.weight.clone()
        table[0] = 0.0
        spatial_bias = table[self.spatial_pos].permute(2, 0, 1)  # [H, J, J]
        # edge features: [J, J, D] -> [D, J*J] -> Linear(J*J -> J*J*H)
        # -> [D, H, J, J] -> [H, J, J, D]
        edge_flat = self.edge_input.permute(2, 0, 1).reshape(d, j * j)
        enc = self.edge_encoder(edge_flat.to(self.W.dtype))
        enc = enc.reshape(d, h, j, j).permute(1, 2, 3, 0)
        edge_bias = (self.W * enc).sum(-1) * self.hop_recip
        return spatial_bias + edge_bias
