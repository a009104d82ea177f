"""Weak-perspective camera and its fits for the demo (counterpart of
gator_tpu/models/camera.py; reference: lib/models/project_net.py:7-23,
demo/run.py:123-164). Tensors carry their own device.

  * `fit_camera_closed_form`: the projection is linear in (s, s·tx, s·ty),
    so a least-squares solve of the 3×3 normal equations gives the fit at
    once (the demo's default);
  * `fit_camera_adam`: the reference's 1500 Adam steps on an L1 loss with
    its two learning-rate drops, in optax's arithmetic (`train.Adam`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..precision import no_tf32
from ..train.schedule import Adam


class CamParams(NamedTuple):
    s: torch.Tensor    # [B, 1] scale
    t: torch.Tensor    # [B, 2] translation


def project_weak_perspective(pose3d: torch.Tensor, cam: CamParams,
                             crop_size: float) -> torch.Tensor:
    """out = (xy + t) · s · res/2 + res/2 (reference: project_net.py:14-17).
    pose3d [B, J, 3] -> [B, J, 2] pixel coordinates in the square crop."""
    res = crop_size / 2.0
    out = pose3d[..., :2] + cam.t[:, None, :]
    return out * cam.s[:, None, :] * res + res


def fit_camera_closed_form(pose3d: torch.Tensor, target2d: torch.Tensor,
                           crop_size: float) -> CamParams:
    """Least-squares (s, t): minimise ||(xy + t) · s · res - (target - res)||.
    With u = s and v = s·t the residual res·(xy·u + v) - y is linear, solved
    per sample from its normal equations in true f32 (TF32 off)."""
    no_tf32()
    res = crop_size / 2.0
    y = (target2d - res) / res            # [B, J, 2]
    x = pose3d[..., :2]                   # [B, J, 2]
    ones = torch.ones_like(x[..., :1])
    zeros = torch.zeros_like(x[..., :1])
    # unknowns [u, vx, vy]; rows: the x coordinates, then the y coordinates
    a = torch.cat([torch.cat([x[..., :1], ones, zeros], -1),
                   torch.cat([x[..., 1:2], zeros, ones], -1)], 1)  # [B,2J,3]
    rhs = torch.cat([y[..., 0], y[..., 1]], 1)                     # [B, 2J]
    ata = a.transpose(1, 2) @ a
    atb = a.transpose(1, 2) @ rhs[..., None]
    sol = torch.linalg.solve(ata, atb)[..., 0]                     # [B, 3]
    s = sol[:, :1]
    t = sol[:, 1:] / torch.where(s.abs() < 1e-8, 1e-8, s)
    return CamParams(s=s, t=t)


def adam_lr(update: int) -> float:
    """The learning rate of update number `update` (0-based, counted
    before the update): optax.piecewise_constant_schedule(0.1, {500: 0.5,
    1000: 0.02}) in its f32 arithmetic (reference: demo/run.py:146-157)."""
    lr = np.float32(0.1)
    for boundary, scale in ((500, 0.5), (1000, 0.02)):
        if update >= boundary:
            lr = lr * np.float32(scale)
    return float(lr)


def _l1(pose3d, p, target2d, crop_size):
    """mean |projection - target|, with |r|'s gradient +1 at r = 0 as in
    JAX (torch's abs has 0 there)."""
    r = project_weak_perspective(pose3d, CamParams(p[:, :1], p[:, 1:]),
                                 crop_size) - target2d
    return (r * torch.where(r >= 0, 1.0, -1.0)).mean()


def fit_camera_adam(pose3d: torch.Tensor, target2d: torch.Tensor,
                    crop_size: float, steps: int = 1500, seed: int = 0,
                    init: Optional[torch.Tensor] = None
                    ) -> Tuple[CamParams, torch.Tensor]:
    """The reference's fit: Adam from a uniform(0, 1) start drawn from a
    torch.Generator seeded `seed` (or from `init` [B, 3]), lr 0.1, 0.05
    from update 500, 0.001 from update 1000, L1 loss (reference:
    demo/run.py:146-157). -> (params, final loss)."""
    pose3d, target2d = pose3d.detach(), target2d.detach()
    if init is None:
        init = torch.rand(pose3d.shape[0], 3,
                          generator=torch.Generator().manual_seed(seed))
    p = init.to(device=pose3d.device, dtype=pose3d.dtype).clone()
    p.requires_grad_(True)
    opt = Adam([p], lr=adam_lr(0))
    with torch.enable_grad():
        for update in range(steps):
            opt.param_groups[0]["lr"] = adam_lr(update)
            p.grad = None
            _l1(pose3d, p, target2d, crop_size).backward()
            opt.step()
    p = p.detach()
    return (CamParams(s=p[:, :1], t=p[:, 1:]),
            _l1(pose3d, p, target2d, crop_size))


def crop_cam_to_orig_img(cam: CamParams, bbox: torch.Tensor,
                         img_width: float, img_height: float
                         ) -> torch.Tensor:
    """Crop-space weak-perspective (s, tx, ty) -> the original image's NDC
    camera [sx, sy, tx, ty] for rendering (reference: demo/run.py:21-39).
    bbox [..., 4] (x, y, w, h)."""
    x, y, w, h = bbox.unbind(-1)
    cx, cy = x + w / 2.0, y + h / 2.0
    hw, hh = img_width / 2.0, img_height / 2.0
    sx = cam.s[..., 0] / (img_width / h)
    sy = cam.s[..., 0] / (img_height / h)
    tx = (cx - hw) / hw / sx + cam.t[..., 0]
    ty = (cy - hh) / hh / sy + cam.t[..., 1]
    return torch.stack([sx, sy, tx, ty], dim=-1)
