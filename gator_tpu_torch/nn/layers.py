"""Basic layers shared by GAT and MDR (counterpart of gator_tpu.nn.layers).

Parity-sensitive pieces:
  * GraphLinear weight orientation [out, in] applied over the channel-major
    [B, C, J] layout (reference: lib/models/backbones/modules.py:31-50);
  * StdLayerNorm — the Annotated-Transformer LayerNorm of MDR's
    self-attention stack: Bessel-corrected std, eps added to the std (NOT
    the variance) (reference: lib/models/vanilla_transformer_encoder.py:
    24-34);
  * GELU is the exact erf form everywhere (the default of torch's F.gelu);
  * GAT's GroupNormCF is torch's own nn.GroupNorm: on [B, C, J] it takes
    per-sample per-group statistics over (C/G, J), biased variance, eps on
    the variance.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class GraphLinear(nn.Module):
    """1x1 graph convolution: x [B, C_in, J] -> [B, C_out, J] with weight
    W [out, in] (reference: lib/models/backbones/modules.py:39-50)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.W = nn.Parameter(torch.empty(out_channels, in_channels))
        self.b = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("oi,bij->boj", self.W, x) + self.b[None, :, None]


def std_layer_norm(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """a * (x - mean) / (std + eps) + b with the n-1 std, computed in f32."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).sum(-1, keepdim=True) / (x.shape[-1] - 1)
    return a * (x32 - mean) / (var.sqrt() + eps) + b


class StdLayerNorm(nn.Module):
    """Module form of `std_layer_norm` (parameters a_2, b_2)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.a_2 = nn.Parameter(torch.ones(features))
        self.b_2 = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return std_layer_norm(x, self.a_2, self.b_2, self.eps).to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2. Both the MDR block MLP and GAT's GatMlp
    (reference: lib/models/MDR.py:62, backbones/modules.py:179-196) are this
    at inference, where their dropouts are identity."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def layer_norm32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Standard LayerNorm over the last axis, computed in f32 whatever the
    input and parameter dtypes (the serving path's `_ln`)."""
    return F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(),
                        eps)
