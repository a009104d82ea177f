"""GATOR composite: GAT lifter + MDR regressor, module form
(counterpart of gator_tpu.models.gator; reference: lib/models/GATOR.py:8-27).
Returns (mesh [B, V0, 3] in meters, lifted 3D pose [B, J, 3] in mm).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..assets.bundle import GatorAssets
from ..nn import MGCN, GraphLinear, HopPathEncoding
from ..nn.gat_trunk import check_width
from .gat import GAT, GatSpec
from .mdr import MDR, Conv1dLen3, MdrSpec


@dataclasses.dataclass(frozen=True, eq=False)
class GatorSpec:
    gat: GatSpec
    mdr: MdrSpec

    @classmethod
    def from_assets(cls, assets: GatorAssets, embed_dim: int = 128,
                    depth: int = 6, alpha: bool = False,
                    **gat_kw) -> "GatorSpec":
        return cls(
            gat=GatSpec.from_assets(assets, embed_dim=embed_dim,
                                    depth=depth, **gat_kw),
            mdr=MdrSpec.from_assets(assets, gat_dim=embed_dim, alpha=alpha),
        )


class GATOR(nn.Module):
    def __init__(self, spec: GatorSpec):
        super().__init__()
        self.spec = spec
        self.pose_lifter = GAT(spec.gat)
        self.pose2mesh = MDR(spec.mdr)

    def forward(self, pose2d: torch.Tensor, use_kernels: bool = True):
        """use_kernels=False runs every attention plain (K3 is the only
        kernel of the module form: the MDR vertex self-attention)."""
        b = pose2d.shape[0]
        j = self.spec.gat.num_joint
        pose2d = pose2d.reshape(b, j, 2)
        pose3d_flat, feat = self.pose_lifter(pose2d)
        pose3d = pose3d_flat.reshape(b, j, 3)
        # concat [2d, 3d/1000, feat] per joint (reference: GATOR.py:19)
        pose_combine = torch.cat([pose2d, pose3d / 1000.0, feat], dim=2)
        return self.pose2mesh(pose_combine, use_kernels), pose3d


def _uniform(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    t.uniform_(-bound, bound, generator=gen)


def init_gator_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter in place with the reference's (torch default)
    initial distributions, drawn from `generator`; the same distributions
    as gator_tpu.nn.initializers, not the same numbers."""
    gen = generator
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                _uniform(mod.weight, bound, gen)
                if mod.bias is not None:
                    _uniform(mod.bias, bound, gen)
            elif isinstance(mod, GraphLinear):
                bound = 1.0 / (mod.in_channels * mod.out_channels)
                _uniform(mod.W, bound, gen)
                _uniform(mod.b, bound, gen)
            elif isinstance(mod, Conv1dLen3):
                bound = 1.0 / math.sqrt(mod.weight.shape[1] * 3)
                _uniform(mod.weight, bound, gen)
                _uniform(mod.bias, bound, gen)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(generator=gen)
                mod.weight[0] = 0.0
            elif isinstance(mod, MGCN):
                # xavier_uniform(gain=1.414) with torch's fan rule on the
                # [2, in, out] and [J, out] shapes
                two, fin, fout = mod.W.shape
                _uniform(mod.W, 1.414 * math.sqrt(
                    6.0 / (fin * fout + two * fout)), gen)
                j, fout = mod.M.shape
                _uniform(mod.M, 1.414 * math.sqrt(6.0 / (fout + j)), gen)
                mod.adj2.fill_(1e-6)
                _uniform(mod.bias, 1.0 / math.sqrt(fout), gen)
            elif isinstance(mod, HopPathEncoding):
                mod.W.fill_(1.0)
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
            elif isinstance(mod, nn.BatchNorm1d):
                mod.reset_parameters()
    return model


def build_gator(spec: GatorSpec, seed: int = 0,
                device="cuda") -> GATOR:
    """A GATOR with seeded random weights, in eval mode, on `device` (the
    card unless the caller asks for the CPU). On the card the lifter's
    (embed_dim, num_heads) must be one the GAT kernels take
    (`nn.gat_trunk.check_width`)."""
    if torch.device(device).type == "cuda":
        check_width(spec.gat.embed_dim, spec.gat.num_heads)
    model = GATOR(spec)
    init_gator_(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)


def build_gat(spec: GatSpec, seed: int = 0, device="cuda") -> GAT:
    """A GAT lifter alone (stage 1) with seeded random weights, in eval
    mode, on `device` (on the card, at a width the GAT kernels take)."""
    if torch.device(device).type == "cuda":
        check_width(spec.embed_dim, spec.num_heads)
    model = GAT(spec)
    init_gator_(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)
