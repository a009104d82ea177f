"""Frozen copy of the port's in-step COCO detector-noise sampler
(gator_tpu_torch/data/device_noise.py `synthesize_pose_device`, its
shipped form: f32 candidates, uniform pick), with its probability tables
(gator_tpu_torch/data/noise.py; reference: lib/noise_utils.py:17-285).

The program draws from a torch.Generator on the card seeded per
optimizer step; this copy draws from its own generator seeded alike, in
the same order and shapes, so the same seed gives the same draws and the
same noise.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

KPS_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87,
    .87, .89, .89]) / 10.0
NUM_KPS = 17
KPS_SYMMETRY = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
                (15, 16))


def _pair_index(j: int):
    for q, w in KPS_SYMMETRY:
        if j == q:
            return w
        if j == w:
            return q
    return None


def _table(vals_head, vals_mid, vals_tail, mid_idx, head_idx):
    t = np.full(NUM_KPS, vals_tail, np.float32)
    t[list(mid_idx)] = vals_mid
    t[list(head_idx)] = vals_head
    return t


_JIT_LOW = _table(.15, .20, .25, range(1, 11), [0, 13, 14, 15, 16])
_JIT_HIGH = _table(.10, .15, .20, range(1, 11), [0, 13, 14, 15, 16])
_MISS_LOW = _table(.15, .20, .25, [5, 6, 15, 16], range(0, 5))
_MISS_MID = _table(.10, .13, .15, [5, 6, 15, 16], range(0, 5))
_MISS_HIGH = _table(.02, .05, .10, [5, 6, 15, 16], range(0, 5))
_INV_P = _table(.01, .03, .06, range(5, 11), range(0, 5))
_PAIR = np.array([(_pair_index(j) if _pair_index(j) is not None else -1)
                  for j in range(NUM_KPS)], np.int64)

_WAVE1 = np.array([j for j in range(NUM_KPS)
                   if _PAIR[j] < 0 or _PAIR[j] > j], np.int64)
_WAVE2 = np.array([j for j in range(NUM_KPS) if 0 <= _PAIR[j] < j],
                  np.int64)
_TWO_PI = float(np.float32(2 * np.pi))
_LOG_KS = {ks: float(np.float32(np.log(ks))) for ks in (0.10, 0.50, 0.85)}


class Draws:
    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.generator.device)


def _constants(device):
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    waves = []
    for wave in (_WAVE1, _WAVE2):
        pair = _PAIR[wave]
        waves.append({
            "J": t(wave, torch.long),
            "p_safe": t(np.where(pair < 0, 0, pair), torch.long),
            "has_pair": t(pair >= 0, torch.bool)[None],
            "jit_low": t(_JIT_LOW[wave])[None],
            "jit_high": t(_JIT_HIGH[wave])[None],
            "miss_low": t(_MISS_LOW[wave])[None],
            "miss_mid": t(_MISS_MID[wave])[None],
            "miss_high": t(_MISS_HIGH[wave])[None],
            "inv": t(np.asarray(_INV_P[wave], np.float32))[None],
        })
    return t(((KPS_SIGMAS * 2) ** 2).astype(np.float32)), waves


def _annulus(draws, centers, r_lo, r_hi, k, reject, reject_r):
    shp = (*centers.shape[:-1], k)
    ang = draws.uniform(shp) * _TWO_PI
    r = draws.uniform(shp) * (r_hi - r_lo)[..., None] + r_lo[..., None]
    px = centers[..., 0, None] + r * torch.cos(ang)
    py = centers[..., 1, None] + r * torch.sin(ang)
    mask = torch.ones(shp, dtype=torch.bool, device=centers.device)
    for other, ovalid in reject:
        dx = px - other[..., 0, None]
        dy = py - other[..., 1, None]
        d = torch.sqrt(dx * dx + dy * dy)
        rr = r if reject_r is None else reject_r[..., None]
        mask = mask & torch.where(ovalid[..., None], d > rr, True)
    return (px, py), mask


def _pick(draws, pts, mask):
    u = draws.uniform(mask.shape)
    sel = torch.where(mask, u, -1.0).argmax(-1, keepdim=True)
    return (torch.cat([c.gather(-1, sel) for c in pts], dim=-1),
            mask.any(-1))


def synthesize(draws: Draws, joints: torch.Tensor, areas: torch.Tensor,
               k: int = 256, k_miss: int = 512) -> torch.Tensor:
    """joints [B, 17, 2] (crop pixels), areas [B] -> noisy [B, 17, 2];
    every joint visible, as the training path passes them."""
    b = joints.shape[0]
    dev = joints.device
    valid = torch.ones((b, NUM_KPS), dtype=torch.bool, device=dev)
    variances, waves = _constants(dev)
    areas = areas.float()

    def ks_dist(ks):
        return torch.sqrt(-2.0 * areas[:, None] * variances[None]
                          * _LOG_KS[ks])

    ks10, ks50, ks85 = ks_dist(0.10), ks_dist(0.50), ks_dist(0.85)
    synth = joints.float()
    num_valid = valid.sum(-1)[:, None]

    for c in waves:
        J = c["J"]
        m = J.shape[0]
        gt = synth[:, J]
        pair_valid = valid[:, c["p_safe"]] & c["has_pair"]
        pair_pos = torch.where(c["has_pair"][..., None],
                               synth[:, c["p_safe"]], 0.0)
        ones = torch.ones((b, m), dtype=torch.bool, device=dev)
        jitter_p = torch.where(num_valid <= 10, c["jit_low"],
                               c["jit_high"])
        miss_p = torch.where(num_valid <= 5, c["miss_low"],
                             torch.where(num_valid <= 10, c["miss_mid"],
                                         c["miss_high"]))
        inv_p = c["inv"].expand(b, m)
        ks85w, ks50w, ks10w = ks85[:, J], ks50[:, J], ks10[:, J]
        zeros_r = torch.zeros((b, m), device=dev)

        # the argument order of each call is the draw order
        jit_pt, jit_ok = _pick(draws, *_annulus(
            draws, gt, ks85w, ks50w, k, [(pair_pos, pair_valid)], None))
        good_pt, good_ok = _pick(draws, *_annulus(
            draws, gt, zeros_r, ks85w, k, [(pair_pos, pair_valid)], None))
        inv_pt, inv_ok = _pick(draws, *_annulus(
            draws, pair_pos, zeros_r, ks50w, k, [(gt, ones)], None))
        inv_ok = inv_ok & pair_valid

        mg_pts, mg_m = _annulus(draws, gt, ks50w, ks10w, k_miss,
                                [(pair_pos, pair_valid)], ks50w)
        mp_pts, mp_m = _annulus(draws, pair_pos, ks50w, ks10w, k_miss,
                                [(gt, ones)], ks50w)
        mp_m = mp_m & pair_valid[..., None]
        n_g = mg_m.sum(-1)
        n_p = mp_m.sum(-1)
        w_p = torch.floor(n_p / 4.0)
        total = n_g + w_p
        take_pair = (draws.uniform((b, m))
                     * torch.clamp(total, min=1e-9)) < w_p
        mg_pt, _ = _pick(draws, mg_pts, mg_m)
        mp_pt, _ = _pick(draws, mp_pts, mp_m)
        miss_pt = torch.where(take_pair[..., None], mp_pt, mg_pt)
        miss_ok = total > 0

        good_p = 1.0 - (jitter_p + miss_p + inv_p)
        probs = torch.stack([jitter_p * jit_ok, miss_p * miss_ok,
                             inv_p * inv_ok, good_p * good_ok], dim=-1)
        z = probs.sum(-1)
        u = draws.uniform((b, m)) * torch.clamp(z, min=1e-12)
        state = torch.clamp(
            (u[..., None] >= torch.cumsum(probs, -1)).sum(-1), max=3)
        cand = torch.stack([jit_pt, miss_pt, inv_pt, good_pt], dim=2).float()
        chosen = cand.gather(2, state[..., None, None].expand(b, m, 1, 2))
        synth = synth.index_copy(1, J, torch.where(
            (z <= 0)[..., None], 0.0, chosen[:, :, 0]))
    return synth
