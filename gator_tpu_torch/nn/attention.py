"""Attention variants used by GAT and MDR, module form (counterpart of
gator_tpu.nn.attention).

`attend` routes as the JAX package's `_attend` and `fused_attention` do
(gator_tpu/nn/attention.py:21-35, pallas_attention.py:159-161): score
tiles of at least 128² (the MDR vertex self-attention, 431 x 431) go to
K3 (`fused_attention`: the CUDA kernel for a CUDA tensor, its plain version
for a CPU tensor); smaller ones (the 17 x 17 GAT attention, the 431 x J
cross-attention) stay plain torch, as they stay XLA in the JAX package.
`use_kernel=False` keeps every shape plain: the plain path a check holds
the kernel path against.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .fused_attention import fused_attention

# the JAX package's threshold for its kernel (pallas_attention.py:160)
FUSED_MIN_SCORES = 128 * 128


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor], scale: float,
           use_kernel: bool = True) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v on q [B, Nq, H, D], k/v [B, Nk, H, D],
    bias [H, Nq, Nk] or None; the softmax runs in f32."""
    if use_kernel and q.shape[1] * k.shape[1] >= FUSED_MIN_SCORES:
        return fused_attention(q, k, v, bias, scale)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    if bias is not None:
        s = s + bias[None].to(s.dtype)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v)


class BiasAttention(nn.Module):
    """MHSA with an additive per-head bias (the GAT hop/path encoding) and a
    fused qkv projection (reference: lib/models/backbones/modules.py:
    109-138)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h)
        out = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_bias,
                     (c // h) ** -0.5)
        return self.proj(out.reshape(b, n, c))


class CrossAttention(nn.Module):
    """MDR joint->vertex cross attention: queries are the first (N-J)
    vertex tokens, keys/values the last J joint tokens; q/k/v carry no bias
    (reference: lib/models/MDR.py:18-46)."""

    def __init__(self, dim: int, joint_num: int, num_heads: int):
        super().__init__()
        self.joint_num = joint_num
        self.num_heads = num_heads
        self.wq = nn.Linear(dim, dim, bias=False)
        self.wk = nn.Linear(dim, dim, bias=False)
        self.wv = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h, nj = self.num_heads, self.joint_num
        nv = n - nj
        q = self.wq(x[:, :nv]).reshape(b, nv, h, c // h)
        k = self.wk(x[:, nv:]).reshape(b, nj, h, c // h)
        v = self.wv(x[:, nv:]).reshape(b, nj, h, c // h)
        out = attend(q, k, v, None, (c // h) ** -0.5)
        return self.proj(out.reshape(b, nv, c))


class MultiHeadedAttention(nn.Module):
    """Annotated-Transformer MHA with four separate linears (q, k, v, out);
    MDR uses it for the vertex self-attention, the one attention of the
    model on K3 (reference: lib/models/vanilla_transformer_encoder.py:
    72-94)."""

    def __init__(self, num_heads: int, d_model: int):
        super().__init__()
        self.num_heads = num_heads
        self.linears = nn.ModuleList(
            [nn.Linear(d_model, d_model) for _ in range(4)])

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, use_kernel: bool = True
                ) -> torch.Tensor:
        b, _, c = query.shape
        h = self.num_heads
        q, k, v = (lin(x).reshape(b, -1, h, c // h)
                   for lin, x in zip(self.linears, (query, key, value)))
        out = attend(q, k, v, None, 1.0 / float(c // h) ** 0.5,
                     use_kernel=use_kernel)
        return self.linears[3](out.reshape(b, -1, c))
