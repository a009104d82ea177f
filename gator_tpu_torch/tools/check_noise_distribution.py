"""The statistical gate of the three detector-noise simulators
(counterpart of tools/check_noise_distribution.py):

    python -m gator_tpu_torch.tools.check_noise_distribution [--n 100000]
        [--seed 0] [--out build/noise_distribution.json] [--workers 3]
        [--device cpu]

At the recipe's crop-space OKS areas it draws n poses (split over the
areas) and pushes them through the scalar oracle
(`data/noise.synthesize_pose`), the host batch form
(`synthesize_pose_batch`) and the device form
(`data/device_noise.synthesize_pose_device`, on the card from a seeded
torch.Generator), then compares with the oracle:
  * the per-state frequencies (good, jitter, miss, inversion, dropped),
    classified from each point's distance to the GT and to the symmetric
    pair (reference: lib/noise_utils.py:70-243);
  * the Kolmogorov-Smirnov distance of the kept joints' error radii.
Pass: every frequency within 0.01 and KS within max(0.01, 3 sqrt(2 / (17
n_area))) for both the batch and the device form. Writes `n_total`,
`ks_bound`, `passed`, `areas` (the JAX tool's per-area dict, key for key),
and the card; exits 1 on a failure. The device form's poses/s is timed to
a synchronize. The three areas' host forms run in --workers processes
(each area restarts its own streams, so the numbers do not depend on
it). Without a CUDA device it fails unless --device cpu is given.

tests/test_torch_paths_cuda.py on the card and the CPU tests share
`gate_poses`, `noise_states` and `noise_gate`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..data import device_noise, noise

# crop-space OKS areas of the training recipe (the post-crop tight-bbox
# area at the 288x384 input; people fill most of the crop)
RECIPE_AREAS = (8000.0, 30000.0, 80000.0)
# a plausible 17-keypoint COCO pose in crop space (pixels)
BASE_POSE = np.array([
    [144, 60], [134, 50], [154, 50], [120, 55], [168, 55],
    [100, 120], [188, 120], [90, 190], [198, 190], [85, 250],
    [203, 250], [115, 210], [173, 210], [110, 290], [178, 290],
    [105, 360], [183, 360]], np.float32)


def gate_poses(n, seed=0):
    """n plausible poses [n, 17, 2] (BASE_POSE with N(0, 4) px jitter) and
    their OKS areas, cycling RECIPE_AREAS (the JAX tool's `make_pose`
    draws, in the same order)."""
    rng = np.random.default_rng(seed)
    poses = BASE_POSE + rng.normal(0, 4.0, (n, 17, 2)).astype(np.float32)
    return poses, np.resize(np.asarray(RECIPE_AREAS, np.float32), n)


def noise_states(xy, gt, areas, dropped=None):
    """[N, 17] error states of simulated keypoints xy [N, 17, 2] against
    the GT gt: 0 good, 1 jitter, 2 miss, 3 inversion (nearer the symmetric
    pair, within its 50 % radius), 4 dropped (`dropped` [N, 17], or a
    zeroed row where it is None), from the distances to the GT and to the
    pair against the radii that define the states."""
    var = (noise.KPS_SIGMAS * 2) ** 2
    ks85 = np.sqrt(-2 * areas[:, None] * var * np.log(0.85))
    ks50 = np.sqrt(-2 * areas[:, None] * var * np.log(0.50))
    d_gt = np.linalg.norm(xy - gt, axis=-1)
    pair = noise._PAIR
    d_pair = np.where(pair >= 0, np.linalg.norm(
        xy - gt[:, np.maximum(pair, 0)], axis=-1), np.inf)
    state = np.where(d_gt <= ks85, 0, np.where(d_gt <= ks50, 1, 2))
    state = np.where((d_pair <= ks50) & (d_pair < d_gt), 3, state)
    if dropped is None:
        dropped = np.abs(xy).sum(-1) <= 0
    return np.where(dropped, 4, state)


def _ks(ra, rb):
    """Kolmogorov-Smirnov distance of two sorted samples."""
    grid = np.unique(np.concatenate([ra, rb]))
    return float(np.abs(np.searchsorted(ra, grid, side="right") / len(ra)
                        - np.searchsorted(rb, grid, side="right") / len(rb))
                 .max())


def noise_gate(dev_xy, host_xy, gt, areas):
    """The gate over all rows of two forms with zeroed dropped rows: every
    state frequency within 0.01 and the KS distance of the kept joints'
    error radii within max(0.01, 3 sqrt(2 / (17 N))). -> (freq diff, KS,
    KS bound)."""
    n = len(gt)
    sd, sh = noise_states(dev_xy, gt, areas), noise_states(host_xy, gt,
                                                           areas)
    diff = float(np.abs(np.bincount(sd.ravel(), minlength=5)
                        - np.bincount(sh.ravel(), minlength=5)).max()
                 / sd.size)

    def radii(xy, states):
        return np.sort(np.linalg.norm(xy - gt, axis=-1)[states != 4])

    ks = _ks(radii(dev_xy, sd), radii(host_xy, sh))
    return diff, ks, max(0.01, 3.0 * np.sqrt(2.0 / (17 * n)))


def _device_form(poses, areas, seed, device):
    """synthesize_pose_device on `device` from a generator seeded `seed`
    -> ([N, 17, 3] with the validity column rebuilt from the zeroed rows,
    seconds to a synchronize)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    joints = torch.from_numpy(poses).to(dev)
    area_t = torch.from_numpy(areas).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = device_noise.synthesize_pose_device(gen, joints, area_t)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    xy = out.cpu().numpy()
    dead = np.abs(xy).sum(-1, keepdims=True) <= 0
    return np.concatenate([xy, (~dead).astype(np.float32)], -1), secs


def _host_forms(full, area, seed):
    """One area's scalar oracle (from default_rng((seed, 1))) and host
    batch form (from default_rng((seed, 2))) -> (scalar, batch, their
    seconds); numpy only, so a worker process can run it."""
    t0 = time.perf_counter()
    rng_s = np.random.default_rng((seed, 1))
    scalar = np.stack([noise.synthesize_pose(full[i], float(area), rng_s)
                       for i in range(len(full))])
    t_scalar = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = noise.synthesize_pose_batch(
        full, np.full(len(full), area, np.float32),
        np.random.default_rng((seed, 2)))
    return scalar, batch, t_scalar, time.perf_counter() - t0


def run(n: int, seed: int = 0, device: str = "cuda",
        workers: int = 1) -> dict:
    """The JAX tool's `run`, form for form: per area, n // 3 poses (the
    pose stream continues across areas), the scalar oracle from
    default_rng((seed, 1)) and the batch form from default_rng((seed, 2))
    (both restarted per area), the device form from a generator seeded
    `seed` on `device`. `workers` > 1 runs the areas' host forms in that
    many processes (the same streams: each area restarts its own).
    -> {"area_<a>": {...}}."""
    rng_pose = np.random.default_rng(seed)
    per_area = max(1, n // len(RECIPE_AREAS))
    poses = [BASE_POSE + rng_pose.normal(0, 4.0, (per_area, 17, 2)).astype(
        np.float32) for _ in RECIPE_AREAS]
    full = [np.concatenate([p, np.ones((per_area, 17, 1), np.float32)], -1)
            for p in poses]
    args = [(f, area, seed) for f, area in zip(full, RECIPE_AREAS)]
    if workers > 1:
        import concurrent.futures
        import multiprocessing
        with concurrent.futures.ProcessPoolExecutor(
                min(workers, len(args)),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            host = list(pool.map(_host_forms, *zip(*args)))
    else:
        host = [_host_forms(*a) for a in args]
    results = {}
    for area, pz, (scalar, batch, t_scalar, t_batch) in zip(
            RECIPE_AREAS, poses, host):
        areas = np.full(per_area, area, np.float32)
        dev, t_dev = _device_form(pz, areas, seed, device)

        def states(synth):
            return noise_states(synth[..., :2], pz, areas,
                                synth[..., 2] <= 0).ravel()

        def freq(synth):
            return np.bincount(states(synth), minlength=5) / (per_area * 17)

        def radii(synth):
            d = np.linalg.norm(synth[..., :2] - pz, axis=-1)
            return np.sort(d[synth[..., 2] > 0])

        fs, fb, fd = freq(scalar), freq(batch), freq(dev)
        rs = radii(scalar)
        results[f"area_{int(area)}"] = {
            "n_poses": per_area,
            "state_freq_scalar": [round(float(x), 5) for x in fs],
            "state_freq_batch": [round(float(x), 5) for x in fb],
            "state_freq_device": [round(float(x), 5) for x in fd],
            "state_freq_max_abs_diff": round(float(np.abs(fs - fb).max()),
                                             5),
            "state_freq_max_abs_diff_device": round(
                float(np.abs(fs - fd).max()), 5),
            "radius_ks_distance": round(_ks(rs, radii(batch)), 5),
            "radius_ks_distance_device": round(_ks(rs, radii(dev)), 5),
            "scalar_poses_per_sec": round(per_area / t_scalar, 1),
            "batch_poses_per_sec": round(per_area / t_batch, 1),
            "device_poses_per_sec": round(per_area / t_dev, 1),
        }
    return results


def gate(results: dict, n: int) -> tuple:
    """The JAX tool's pass bars over `run`'s dict -> (passed, KS bound,
    {area: passed})."""
    n_per = n // len(RECIPE_AREAS)
    ks_bound = max(0.01, 3.0 * np.sqrt(2.0 / (n_per * 17)))
    each = {k: (r["state_freq_max_abs_diff"] <= 0.01
                and r["radius_ks_distance"] <= ks_bound
                and r["state_freq_max_abs_diff_device"] <= 0.01
                and r["radius_ks_distance_device"] <= ks_bound)
            for k, r in results.items()}
    return all(each.values()), ks_bound, each


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100000,
                    help="total poses (split over the recipe areas)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/noise_distribution.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--workers", type=int, default=3,
                    help="processes for the areas' host forms")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("check_noise_distribution: no CUDA device")
    card = None
    if args.device == "cuda":
        from .timing import card_name
        card = card_name()
    results = run(args.n, args.seed, args.device, args.workers)
    ok, ks_bound, each = gate(results, args.n)
    for k, r in results.items():
        print(f"{k}: freq_diff={r['state_freq_max_abs_diff']} "
              f"ks={r['radius_ks_distance']} "
              f"dev_freq_diff={r['state_freq_max_abs_diff_device']} "
              f"dev_ks={r['radius_ks_distance_device']} "
              f"(bound {ks_bound:.4f}) {'OK' if each[k] else 'FAIL'}; "
              f"device form {r['device_poses_per_sec']} poses/s on "
              f"{card or 'the CPU'}")
    payload = {"n_total": args.n, "ks_bound": round(float(ks_bound), 5),
               "passed": bool(ok), "areas": results, "device": args.device,
               "card": card}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"-> {args.out}")
    if not ok:
        raise SystemExit(1)
    return payload


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
