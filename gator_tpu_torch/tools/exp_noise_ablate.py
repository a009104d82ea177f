"""Ablation of the in-step detector-noise sampler
(`data/device_noise.synthesize_pose_device`) on one CUDA device
(counterpart of tools/exp_noise_ablate.py):

    python -m gator_tpu_torch.tools.exp_noise_ablate
        [--batches 512 1024 4096] [--out build/noise_ablation.json]
        [--device cpu]

The sampler's cheap levers, each at every batch of --batches:
  * shipped_f32: the shipped form (a uniform pick among the accepted
    candidates by the argmax of iid uniforms, the "gumbel" pick);
  * gumbel_pick: `make_variant(f32, gumbel_pick=True)`, the same function
    through the variant path (bit-equal to shipped_f32 on the same draws);
  * bf16: the candidate and distance math in bf16 with the legacy pick
    (count the accepted, draw one index, find it by cumsum);
  * bf16_gumbel: bf16 with the argmax pick;
  * annulus_mask_only and rng_draws_only: the five annuli's candidates and
    rejection tests alone, and their uniform draws alone.
Per variant and batch: ms a call (CUDA events, median of runs of three
calls), device ms and kernel launches a call (torch.profiler) and host ms
a call (median of synchronised calls). Every variant is held to the
shipped form's band frequencies (inside the 85 % OKS radius, between it
and the 50 % one, outside) at B=4096 (`check_distribution`, bar 0.02).
The JAX tool's serial fori_loop timing (a relay workaround) is not
ported. Writes `times_ms`, `dist_max_band_diff`, `device_ms`,
`launches`, `host_ms`, `card` and `not_ported` to --out. Without a CUDA
device it fails unless --device cpu is given; then the times are the
host clock's and no device number is reported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..data import device_noise as dn
from ..data.noise import KPS_SIGMAS
from .check_noise_distribution import BASE_POSE

BATCHES = (512, 1024, 4096)
DIST_BATCH = 4096            # the distribution check's batch
NOT_PORTED = {
    "fori_loop timing": "a serial lax.fori_loop of two lengths worked "
                        "round the relay's per-dispatch cost; CUDA events "
                        "and torch.profiler time each call here",
}


def cumsum_pick(draws, path, pts, mask):
    """The legacy pick (the JAX tool's `gumbel_pick=False`): count a row's
    accepted candidates, draw one index uniformly among them and find it
    by cumsum -> (pt [..., 2], ok [...])."""
    cnt = mask.sum(-1)
    u = draws.uniform(path, cnt.shape)
    m = torch.minimum((u * cnt.clamp(min=1)).to(torch.int64),
                      (cnt - 1).clamp(min=0))
    hit = torch.cumsum(mask.to(torch.int64), -1) == (m + 1)[..., None]
    sel = hit.to(torch.uint8).argmax(-1, keepdim=True)
    return (torch.cat([c.gather(-1, sel) for c in pts], dim=-1), cnt > 0)


def make_variant(dtype=torch.float32, gumbel_pick=False):
    """The sampler with its candidate math in `dtype` and the argmax
    ("gumbel") pick or the cumsum pick -> fn(draws, joints, areas)."""
    pick = dn._pick if gumbel_pick else cumsum_pick

    def fn(draws, joints, areas):
        return dn.synthesize(draws, joints, areas, dtype=dtype, pick=pick)

    return fn


def make_components():
    """(annulus_mask_only, rng_draws_only): the five annuli of each wave
    (three of k candidates, two of k_miss) with their rejection test
    against the GT alone, and their uniform draws alone."""
    def annuli(draws, joints, areas, body, k=256, k_miss=512):
        draws = dn._as_draws(draws)
        variances, waves = dn.wave_constants(joints.device)
        ks50 = torch.sqrt(-2.0 * areas[:, None] * variances[None]
                          * dn._LOG_KS[0.50])
        b = joints.shape[0]
        acc = torch.zeros((), device=joints.device)
        for w, c in enumerate(waves):
            J = c["J"]
            gt, r50 = joints[:, J], ks50[:, J]
            for i, kk in enumerate((k, k, k, k_miss, k_miss)):
                shp = (b, J.shape[0], kk)
                acc = acc + body(draws.uniform((w, i, 0), shp),
                                 draws.uniform((w, i, 1), shp), gt, r50)
        return joints + acc * 1e-20

    def mask_body(ua, ur, gt, r50):
        ang = ua * dn._TWO_PI
        r = ur * r50[..., None]
        dx = r * torch.cos(ang)
        dy = r * torch.sin(ang)
        px, py = gt[..., 0, None] + dx, gt[..., 1, None] + dy
        d = torch.sqrt((px - gt[..., 0, None]) ** 2
                       + (py - gt[..., 1, None]) ** 2)
        return (d > r).sum()

    def rng_body(ua, ur, gt, r50):
        return ua.sum() + ur.sum()

    def annulus_only(draws, joints, areas):
        return annuli(draws, joints, areas, mask_body)

    def rng_only(draws, joints, areas):
        return annuli(draws, joints, areas, rng_body)

    return annulus_only, rng_only


def variants() -> dict:
    """The JAX tool's four variants under their names."""
    return {"shipped_f32": lambda d, j, a: dn.synthesize_pose_device(d, j, a),
            "bf16": make_variant(torch.bfloat16),
            "gumbel_pick": make_variant(torch.float32, gumbel_pick=True),
            "bf16_gumbel": make_variant(torch.bfloat16, gumbel_pick=True)}


def band_freqs(out, gt, areas):
    """[17, 3] per joint: the share of rows inside the 85 % OKS radius,
    between it and the 50 % one, and outside."""
    var = (KPS_SIGMAS * 2) ** 2
    ks85 = np.sqrt(-2 * areas[:, None] * var[None] * np.log(0.85))
    ks50 = np.sqrt(-2 * areas[:, None] * var[None] * np.log(0.50))
    r = np.linalg.norm(out - gt, axis=-1)
    return np.stack([(r <= ks85).mean(0),
                     ((r > ks85) & (r <= ks50)).mean(0),
                     (r > ks50).mean(0)], axis=1)


def make_inputs(b, seed=0):
    """b poses (BASE_POSE with N(0, 4) px jitter) at area 30000, as the
    JAX tool's `make_inputs` draws them -> numpy (joints, areas)."""
    rng = np.random.default_rng(seed)
    joints = BASE_POSE[None] + rng.normal(0, 4.0, (b, 17, 2)).astype(
        np.float32)
    return joints, np.full(b, 30000.0, np.float32)


def check_distribution(fn, ref_fn, device, b=DIST_BATCH):
    """Max |band-frequency difference| between fn and ref_fn at B=b, each
    from its own seeded generator on `device`."""
    joints, areas = make_inputs(b, seed=3)
    jt, at = (torch.from_numpy(a).to(device) for a in (joints, areas))
    out = fn(torch.Generator(device=device).manual_seed(5), jt, at)
    ref = ref_fn(torch.Generator(device=device).manual_seed(6), jt, at)
    return float(np.abs(band_freqs(out.float().cpu().numpy(), joints, areas)
                        - band_freqs(ref.float().cpu().numpy(), joints,
                                     areas)).max())


def run(batches=BATCHES, device="cuda") -> dict:
    from .timing import measure, time_ms
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    annulus_only, rng_only = make_components()
    fns = {**variants(), "annulus_mask_only": annulus_only,
           "rng_draws_only": rng_only}
    res = {"times_ms": {}, "device_ms": {}, "launches": {}, "host_ms": {},
           "dist_max_band_diff": {}}
    for b in batches:
        joints, areas = make_inputs(b)
        jt, at = (torch.from_numpy(a).to(dev) for a in (joints, areas))
        for name, fn in fns.items():
            gen = torch.Generator(device=dev).manual_seed(0)

            def call():
                return fn(gen, jt, at)

            key = f"{name}_b{b}"
            got = measure(call, cuda)
            # CUDA events on the card, the host clock on the CPU
            res["times_ms"][key] = time_ms(call) if cuda else got["host_ms"]
            for k in ("device_ms", "launches", "host_ms"):
                res[k][key] = got[k]
    shipped = fns["shipped_f32"]
    for name, fn in variants().items():
        if name != "shipped_f32":
            res["dist_max_band_diff"][name] = check_distribution(
                fn, shipped, dev, DIST_BATCH)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    ap.add_argument("--out", default="build/noise_ablation.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("exp_noise_ablate: no CUDA device")
    card = None
    if args.device == "cuda":
        from .timing import card_name
        card = card_name()
    res = run(args.batches, args.device)
    res.update(card=card, device=args.device, not_ported=NOT_PORTED)
    where = card or "the CPU (host clock)"
    for key, ms in res["times_ms"].items():
        b = int(key.rsplit("_b", 1)[1])
        dev_ms = res["device_ms"][key]
        extra = ("" if dev_ms is None else
                 f", device {dev_ms:.3f} ms, {res['launches'][key]:.0f} "
                 f"launches, host {res['host_ms'][key]:.3f} ms")
        print(f"{key:28s} {ms:8.3f} ms a call ({b / ms * 1e3:10.0f} "
              f"poses/s){extra}")
    for name, d in res["dist_max_band_diff"].items():
        print(f"{name:20s} max band-frequency diff against shipped_f32 at "
              f"B={DIST_BATCH}: {d:.5f} "
              f"({'OK' if d < 0.02 else 'SUSPECT'})")
    print(f"on {where}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print("->", args.out)
    return res


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
