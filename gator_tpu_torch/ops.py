"""Mesh and graph operators on tensors (counterpart of gator_tpu/ops.py;
reference: lib/models/backbones/mesh.py:93-123 sparse down/upsample,
lib/models/backbones/graph_layers.py:11-124 GraphConvolution /
GraphResBlock). The resampling matrices and adjacencies are dense (at
1723x6890 dense products beat sparse ones), and every product is true f32
(TF32 off). Parameter names follow the flax modules', so
`convert.state_dict_from_jax` loads a JAX GraphResBlock strictly.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .assets.mesh_sampling import MeshSampling
from .nn import GraphLinear
from .precision import no_tf32


class MeshResampler(nn.Module):
    """Batched mesh down/upsampling through the dense operators of a
    `MeshSampling` (replaces the reference's per-sample sparse loops,
    mesh.py:93-123); the operators are buffers, so `.to(device)` moves
    them."""

    def __init__(self, sampling: MeshSampling):
        super().__init__()
        for name in ("down1", "down2", "up1", "up2"):
            self.register_buffer(name, torch.as_tensor(
                getattr(sampling, name), dtype=torch.float32),
                persistent=False)

    def downsample(self, x: torch.Tensor, n1: int = 0,
                   n2: int = 1) -> torch.Tensor:
        """x [..., V, C]; levels n1..n2 as in the reference API."""
        no_tf32()
        down = (self.down1, self.down2)
        for i in range(n1, n2):
            x = down[i] @ x
        return x

    def upsample(self, x: torch.Tensor, n1: int = 1,
                 n2: int = 0) -> torch.Tensor:
        no_tf32()
        up = (self.up1, self.up2)
        for i in reversed(range(n2, n1)):
            x = up[i] @ x
        return x


class GraphConvolution(nn.Module):
    """Kipf-style GCN layer over a fixed (row-normalised) adjacency
    (reference: graph_layers.py:11-53): adj · x · weight + bias, with
    weight [in, out] as in flax."""

    def __init__(self, in_features: int, features: int,
                 adjacency: np.ndarray, use_bias: bool = True):
        super().__init__()
        bound = 6.0 / np.sqrt(in_features + features)
        self.weight = nn.Parameter(
            torch.empty(in_features, features).uniform_(-bound, bound))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.register_buffer("adjacency", torch.as_tensor(
            np.asarray(adjacency), dtype=torch.float32), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        no_tf32()
        out = self.adjacency @ (x @ self.weight)
        return out if self.bias is None else out + self.bias


class GraphResBlock(nn.Module):
    """Residual GCN block: GraphLinear shrink -> GCN -> GraphLinear expand
    with pre-norm ReLUs (reference: graph_layers.py:76-110), on x
    [B, V, C]. flax's GroupNorm normalises the last axis of [B, V, C] with
    eps 1e-6; torch's takes [B, C, V] and the eps is given."""

    def __init__(self, in_channels: int, out_channels: int,
                 adjacency: np.ndarray):
        super().__init__()
        hidden = out_channels // 2
        self.pre_norm = nn.GroupNorm(min(8, in_channels), in_channels,
                                     eps=1e-6)
        self.lin1 = GraphLinear(in_channels, hidden)
        self.norm = nn.GroupNorm(min(8, hidden), hidden, eps=1e-6)
        self.conv = GraphConvolution(hidden, hidden, adjacency)
        self.post_norm = nn.GroupNorm(min(8, hidden), hidden, eps=1e-6)
        self.lin2 = GraphLinear(hidden, out_channels)
        self.skip = (GraphLinear(in_channels, out_channels)
                     if in_channels != out_channels else None)
        for lin in (self.lin1, self.lin2, self.skip):
            if lin is not None:   # flax's GraphLinear initialisation
                bound = 1.0 / (lin.in_channels * lin.out_channels)
                nn.init.uniform_(lin.W, -bound, bound)
                nn.init.uniform_(lin.b, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        no_tf32()
        xc = x.transpose(-1, -2)                            # [B, C, V]
        y = self.lin1(torch.relu(self.pre_norm(xc)))
        y = torch.relu(self.norm(y)).transpose(-1, -2)      # [B, V, C]
        y = self.conv(y).transpose(-1, -2)
        y = self.lin2(torch.relu(self.post_norm(y)))
        if self.skip is not None:
            xc = self.skip(xc)
        return (xc + y).transpose(-1, -2)


def row_normalized_adjacency(adj: np.ndarray, nsize: int = 1) -> np.ndarray:
    """Binary n-hop adjacency with self loops, row-normalized
    (reference: mesh.py:29-48 `adjmat_sparse`)."""
    a = (np.asarray(adj) != 0).astype(np.float64)
    out = a.copy()
    for _ in range(1, nsize):
        out = (out @ a > 0).astype(np.float64)
    np.fill_diagonal(out, 1.0)
    out = out / out.sum(axis=1, keepdims=True)
    return out.astype(np.float32)
