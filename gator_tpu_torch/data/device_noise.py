"""Detector-noise synthesis on the device (counterpart of
gator_tpu/data/device_noise.py): the COCO keypoint-error simulator
(`synthesize_pose_device`) and the Human3.6M Gaussian detector error
(`h36m_syn_error_device`) as plain torch on whatever device the inputs are
on, so the `device` input path (data/packed.py) can draw the 2D input's
noise inside the train step and the host ships ~12 B a sample.

Semantics are the host batched simulator's (`noise.synthesize_pose_batch`,
reference: lib/noise_utils.py:17-285) state for state: k=256 / k_miss=512
candidates, the same probability tables, radii, rejections and weighting.
Only the random stream differs, so against the host form the contract is
distributional (the gate of tools/check_noise_distribution.py).

The 17 joints split into two waves by their symmetric pair (wave 1: the
pair is later or absent and still at its original position; wave 2: the
pair was synthesised in wave 1); within a wave no joint reads another, so
each wave runs as one [B, m, K] program, as in the JAX form.

Random draws. Every draw goes through a `Draws` object, named by a path
that stands for the JAX form's key derivation:
  * `synthesize_pose_device`: (w, i) is `split(fold_in(key, w), 12)[i]`;
    (w, i, 0) and (w, i, 1) are the angle and radius halves of
    `split(that key)` in an annulus;
  * `h36m_syn_error_device`: (0,) is the normal draw, (1,) the uniform of
    `split(key)`.
`GeneratorDraws` draws from a torch.Generator on the tensors' device in
call order (the path is not used); a test can pass an object that returns
the JAX form's own uniforms by path, and the functions then compute the JAX
form's function of them. Nothing here synchronises with the host: no
`.item()`, no `nonzero`, no boolean-mask indexing, no branch on a value,
and the constant tables are copied to each device once (`wave_constants`).
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from .noise import (_INV_P, _JIT_HIGH, _JIT_LOW, _MISS_HIGH, _MISS_LOW,
                    _MISS_MID, _PAIR, KPS_SIGMAS, NUM_KPS)

# the two dependency waves: wave 1 = joints whose pair is later (or
# absent), wave 2 = joints whose pair is earlier
_WAVE1 = np.array([j for j in range(NUM_KPS)
                   if _PAIR[j] < 0 or _PAIR[j] > j], np.int64)
_WAVE2 = np.array([j for j in range(NUM_KPS) if 0 <= _PAIR[j] < j],
                  np.int64)
_TWO_PI = float(np.float32(2 * np.pi))      # jax.random.uniform's maxval
_LOG_KS = {ks: float(np.float32(np.log(ks))) for ks in (0.10, 0.50, 0.85)}


class Draws:
    """Where the device simulators take their random numbers: `uniform`
    in [0, 1) and `normal`, f32, of `shape`, for the draw named `path`."""

    def uniform(self, path: tuple, shape: Sequence[int]) -> torch.Tensor:
        raise NotImplementedError

    def normal(self, path: tuple, shape: Sequence[int]) -> torch.Tensor:
        raise NotImplementedError


class GeneratorDraws(Draws):
    """Draws from one torch.Generator, in call order, on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, path, shape):
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.generator.device)

    def normal(self, path, shape):
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device)


class RowDraws(GeneratorDraws):
    """A data-parallel rank's draws: each draw is made for the global batch
    of `size` times the rank's rows (the leading dim of every draw here is
    the batch), from the one generator every rank seeds alike, and the
    rank keeps its rows [rank*b, (rank+1)*b). The rank then draws what the
    one-device step draws for those rows, and no two ranks share a
    draw."""

    def __init__(self, generator: torch.Generator, rank: int, size: int):
        super().__init__(generator)
        self.rank, self.size = rank, size

    def _rows(self, draw, shape):
        b = int(shape[0])
        full = draw(self, None, (b * self.size,) + tuple(shape[1:]))
        return full[self.rank * b:(self.rank + 1) * b]

    def uniform(self, path, shape):
        return self._rows(GeneratorDraws.uniform, shape)

    def normal(self, path, shape):
        return self._rows(GeneratorDraws.normal, shape)


def _as_draws(draws) -> Draws:
    return (GeneratorDraws(draws) if isinstance(draws, torch.Generator)
            else draws)


@functools.lru_cache(maxsize=None)
def wave_constants(device: torch.device):
    """The simulator's tables on `device`, copied once per device:
    (variances [17], one dict per wave of joint and pair indices and
    probability rows [1, m])."""
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
    return t(((KPS_SIGMAS * 2) ** 2).astype(np.float32)), tuple(waves)


def _annulus(draws: Draws, path, centers, r_lo, r_hi, k, reject, reject_r,
             dtype: torch.dtype = torch.float32):
    """K candidates per row, uniform in the [r_lo, r_hi] annulus around
    centers [..., 2]; reject = [(other [..., 2], other_valid [...])]
    rejects points within reject_r (or the point's own radius when None)
    of the other centers. -> ((x, y) [..., K] each, accept [..., K]); the
    coordinates stay apart (no [..., K, 2] tensor is made). `dtype`: the
    candidates' and distances' working type (f32 ships;
    `tools.exp_noise_ablate` tries bf16)."""
    shp = (*centers.shape[:-1], k)
    ang = draws.uniform(path + (0,), shp).to(dtype) * _TWO_PI
    r = (draws.uniform(path + (1,), shp).to(dtype)
         * (r_hi - r_lo).to(dtype)[..., None] + r_lo.to(dtype)[..., None])
    centers = centers.to(dtype)
    px = centers[..., 0, None] + r * torch.cos(ang)
    py = centers[..., 1, None] + r * torch.sin(ang)
    mask = torch.ones(shp, dtype=torch.bool, device=centers.device)
    for other, ovalid in reject:
        other = other.to(dtype)
        dx = px - other[..., 0, None]
        dy = py - other[..., 1, None]
        d = torch.sqrt(dx * dx + dy * dy)
        rr = r if reject_r is None else reject_r.to(dtype)[..., None]
        mask = mask & torch.where(ovalid[..., None], d > rr, True)
    return (px, py), mask


def _pick(draws: Draws, path, pts, mask):
    """Uniform pick among each row's accepted candidates -> (pt [..., 2],
    ok [...]): the argmax of iid uniforms (in the points' dtype) over the
    accepted set (an all-rejected row picks index 0, as jnp.argmax
    does)."""
    u = draws.uniform(path, mask.shape).to(pts[0].dtype)
    sel = torch.where(mask, u, -1.0).argmax(-1, keepdim=True)
    return (torch.cat([c.gather(-1, sel) for c in pts], dim=-1),
            mask.any(-1))


def synthesize_pose_device(draws, joints: torch.Tensor, areas: torch.Tensor,
                           valid: torch.Tensor | None = None,
                           k: int = 256, k_miss: int = 512) -> torch.Tensor:
    """Device `synthesize_pose_batch`: joints [B, 17, 2], areas [B], valid
    [B, 17] (all visible by default, as the training path passes) ->
    [B, 17, 2], a row zeroed where no state had a candidate. `draws` is a
    `Draws` or a torch.Generator on the joints' device."""
    return synthesize(draws, joints, areas, valid, k, k_miss)


def synthesize(draws, joints: torch.Tensor, areas: torch.Tensor,
               valid: torch.Tensor | None = None, k: int = 256,
               k_miss: int = 512, dtype: torch.dtype = torch.float32,
               pick=_pick) -> torch.Tensor:
    """`synthesize_pose_device` with its levers open: `dtype` the
    candidate math's working type (`_annulus`), `pick(draws, path, pts,
    mask) -> (pt, ok)` the pick among a row's accepted candidates. The
    defaults are the shipped form; `tools.exp_noise_ablate` measures the
    others."""
    draws = _as_draws(draws)
    b = joints.shape[0]
    dev = joints.device
    valid = (torch.ones((b, NUM_KPS), dtype=torch.bool, device=dev)
             if valid is None else valid.bool())
    variances, waves = wave_constants(dev)
    areas = areas.float()

    def ks_dist(ks):
        return torch.sqrt(-2.0 * areas[:, None] * variances[None]
                          * _LOG_KS[ks])

    ks10, ks50, ks85 = ks_dist(0.10), ks_dist(0.50), ks_dist(0.85)
    synth = joints.float()
    num_valid = valid.sum(-1)[:, None]          # [B, 1]

    for w, c in enumerate(waves):
        J = c["J"]
        m = J.shape[0]
        gt = synth[:, J]                          # [B, m, 2]
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

        jit_pt, jit_ok = pick(draws, (w, 0), *_annulus(
            draws, (w, 1), gt, ks85w, ks50w, k, [(pair_pos, pair_valid)],
            None, dtype))
        good_pt, good_ok = pick(draws, (w, 2), *_annulus(
            draws, (w, 3), gt, zeros_r, ks85w, k, [(pair_pos, pair_valid)],
            None, dtype))
        inv_pt, inv_ok = pick(draws, (w, 4), *_annulus(
            draws, (w, 5), pair_pos, zeros_r, ks50w, k, [(gt, ones)], None,
            dtype))
        inv_ok = inv_ok & pair_valid

        mg_pts, mg_m = _annulus(draws, (w, 6), gt, ks50w, ks10w, k_miss,
                                [(pair_pos, pair_valid)], ks50w, dtype)
        mp_pts, mp_m = _annulus(draws, (w, 7), pair_pos, ks50w, ks10w,
                                k_miss, [(gt, ones)], ks50w, dtype)
        mp_m = mp_m & pair_valid[..., None]
        n_g = mg_m.sum(-1)
        n_p = mp_m.sum(-1)
        # pair-centred candidates enter the pick with weight floor(n_p/4)
        # against the n_g gt-centred ones (the host form's resample)
        w_p = torch.floor(n_p / 4.0)
        total = n_g + w_p
        take_pair = (draws.uniform((w, 8), (b, m))
                     * torch.clamp(total, min=1e-9)) < w_p
        mg_pt, _ = pick(draws, (w, 9), mg_pts, mg_m)
        mp_pt, _ = pick(draws, (w, 10), mp_pts, mp_m)
        miss_pt = torch.where(take_pair[..., None], mp_pt, mg_pt)
        miss_ok = total > 0

        good_p = 1.0 - (jitter_p + miss_p + inv_p)
        probs = torch.stack([jitter_p * jit_ok, miss_p * miss_ok,
                             inv_p * inv_ok, good_p * good_ok], dim=-1)
        z = probs.sum(-1)
        u = draws.uniform((w, 11), (b, m)) * torch.clamp(z, min=1e-12)
        state = torch.clamp(
            (u[..., None] >= torch.cumsum(probs, -1)).sum(-1), max=3)
        cand = torch.stack([jit_pt, miss_pt, inv_pt, good_pt], dim=2).float()
        chosen = cand.gather(2, state[..., None, None].expand(b, m, 1, 2))
        synth = synth.index_copy(1, J, torch.where(
            (z <= 0)[..., None], 0.0, chosen[:, :, 0]))
    return synth


def h36m_syn_error_device(draws, stats: torch.Tensor, b: int,
                          input_shape) -> torch.Tensor:
    """Device `generate_h36m_syn_error` with the host path's rescale to the
    input shape (reference: Human36M/dataset.py:143-155,423): per-joint
    Gaussian detector error in 256-crop pixels, each joint perturbed with
    probability `weight`. stats [J, 5] on the device -> [B, J, 2] additive
    crop-space noise."""
    draws = _as_draws(draws)
    j = stats.shape[0]
    noise = (stats[None, :, 0:2]
             + draws.normal((0,), (b, j, 2)) * stats[None, :, 2:4])
    keep = stats[None, :, 4] > draws.uniform((1,), (b, j))
    noise = noise * keep[..., None]
    return torch.stack([noise[..., 0] * float(np.float32(input_shape[1]
                                                         / 256.0)),
                        noise[..., 1] * float(np.float32(input_shape[0]
                                                         / 256.0))], dim=-1)
