"""Stage-2 training steps in plain float32 PyTorch: the model forward with
the training kernels' dropout and DropPath masks (masks.py), the stage-2
loss (reference: lib/core/loss.py, lib/core/base.py:139-148), autograd's
backward, and Adam in optax's arithmetic (lib/funcs_utils.py:76-107).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import model as ref
from .masks import keep_mask, step_seed

BUFFERS = ("running_mean", "running_var")


def mask_fn(cfg: dict, seed: int, batch: int, device,
            sample0: int = 0) -> Callable:
    """masks(unit, mid, shape) for one step: the rates of the unit's
    site (GAT blocks from unit 256 on, LBF layers below)."""
    g = ref.GAT_RATES
    paths = np.linspace(0.0, g["path_max"], cfg["gat"]["depth"])
    lbf = ref.LBF_RATES

    def rate(unit, mid):
        if unit >= ref.GAT_UNIT_BASE:
            if mid < ref.M_PROJ:
                return g["attn"]
            if mid == ref.M_PROJ:
                return g["proj"]
            if mid in (ref.M_MLP1, ref.M_MLP2):
                return g["mlp"]
            return float(paths[unit - ref.GAT_UNIT_BASE])     # DP1, DP2
        if mid < ref.M_PROJ:
            return lbf["attn"]
        if mid >= ref.M_OUT:
            return lbf["out"]
        if mid >= ref.M_SELF0:
            return lbf["self"]
        return {ref.M_PROJ: lbf["proj"], ref.M_DP1: lbf["path"],
                ref.M_DP2: lbf["path"], ref.M_MLP1: lbf["mlp"],
                ref.M_MLP2: lbf["mlp"]}[mid]

    def masks(unit, mid, shape):
        return keep_mask(seed, unit, mid, rate(unit, mid), batch, shape,
                         device, sample0)

    return masks


def l1(pred, gt, valid):
    return (pred * valid - gt * valid).abs().mean()


def _unit(x, eps=1e-12):
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                      min=eps * eps))


def stage2_loss(mesh, pose3d, batch, faces, j_target, weights: Dict,
                edge_on: float) -> torch.Tensor:
    """Vertex L1 + normal + (gated) edge + the two joint L1s."""
    pred_pose = torch.einsum("jv,bvc->bjc", j_target, mesh * 1000.0)
    loss = l1(mesh, batch["mesh"], batch["mesh_valid"])
    p = [mesh[:, faces[:, i]] for i in range(3)]
    g = [batch["mesh"][:, faces[:, i]] for i in range(3)]
    normal = _unit(torch.cross(_unit(g[1] - g[0]), _unit(g[2] - g[0]),
                               dim=-1))
    cos = [(_unit(b - a) * normal).sum(-1).abs()
           for a, b in ((p[0], p[1]), (p[0], p[2]), (p[1], p[2]))]
    loss = loss + weights["normal"] * torch.cat(cos, 1).mean()

    def length(a, b):
        return torch.sqrt(torch.clamp(((a - b) ** 2).sum(-1), min=1e-24))

    d = [(length(p[i], p[j]) - length(g[i], g[j])).abs()
         for i, j in ((0, 1), (0, 2), (1, 2))]
    loss = loss + weights["edge"] * edge_on * torch.cat(d, 1).mean()
    loss = loss + weights["joint"] * l1(pred_pose, batch["reg_pose3d"],
                                        batch["reg_valid"])
    return loss + weights["joint"] * l1(pose3d, batch["lift_pose3d"],
                                        batch["lift_valid"])


class Adam:
    """optax.adam's arithmetic: bias corrections, m / (sqrt(v) + eps)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr * (self.mu[k] / c1)
                   / (torch.sqrt(self.nu[k] / c2) + self.eps))


def run_steps(w0: Dict[str, torch.Tensor], tables, cfg: dict,
              batches: Sequence[Dict[str, torch.Tensor]], seed: int,
              lr: float, faces, j_target, weights: Dict,
              edge_on: float, sample0: int = 0, prec=ref.F32) -> Dict:
    """len(batches) steps from w0 -> {"loss": [per step], "grad1": {leaf:
    norm of step 1's gradient}, "delta": {leaf: norm of the change}}."""
    ref.no_tf32()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in w0.items() if not k.endswith(BUFFERS)}
    bufs = {k: v.detach().clone() for k, v in w0.items()
            if k.endswith(BUFFERS)}
    opt = Adam(params, lr)
    out: Dict = {"loss": [], "grad1": {}, "delta": {}}
    for s, batch in enumerate(batches):
        w = {**params, **bufs}
        masks = mask_fn(cfg, step_seed(seed, s), batch["pose2d"].shape[0],
                        batch["pose2d"].device, sample0)
        mesh, pose3d, stats = ref.forward(w, tables, cfg, batch["pose2d"],
                                          prec=prec, masks=masks, train=True)
        loss = stage2_loss(mesh, pose3d, batch, faces, j_target, weights,
                           edge_on)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in grads.items()}
        out["loss"].append(float(loss.detach()))
        if s == 0:
            out["grad1"] = {k: float(torch.linalg.vector_norm(g))
                            for k, g in grads.items()}
        opt.step(params, grads)
        if stats is not None:
            p = "pose2mesh.bias_norm."
            bufs[p + "running_mean"], bufs[p + "running_var"] = stats
        del mesh, pose3d, loss, grads
    out["delta"] = {k: float(torch.linalg.vector_norm(
        params[k].detach() - w0[k])) for k in params}
    return out


def norm_gap(got: Dict[str, float], want: Dict[str, float],
             leaves: Optional[List[str]] = None, median: bool = False
             ) -> tuple:
    """The worst leaf's gap of norms, |got - want| over the larger of the
    reference's norm of that leaf and the median leaf's -> (gap, leaf);
    with `median`, the median leaf's gap instead of the worst's."""
    leaves = list(want) if leaves is None else leaves
    med = float(np.median([want[k] for k in leaves]))
    gaps = sorted((abs(got.get(k, 0.0) - want[k]) / max(want[k], med), k)
                  for k in leaves)
    return gaps[len(gaps) // 2] if median else gaps[-1]
