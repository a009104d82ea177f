"""Where the time of a training step goes, on one CUDA device.

    python -m gator_tpu_torch.tools.profile_train [--stage 2]
        [--out build/profile_train.json]

Builds the full-width synthetic human36 model (seeded random weights), runs
three warm-up steps of the stage-2 (or stage-1) train step at B=512 in
bf16 (the JAX package's TRAIN_BATCH, bench.py:58) on a fixed batch of
bench.py's training shapes, times five steps on the host clock, then
profiles five more with
torch.profiler (CPU and CUDA activities). Prints the step time on the host
clock (synchronised), the device time per kernel group (K5 forward and
backward, each launch of K4, the gradient-partial reduction, and the
largest plain-torch kernels), and the device's busy and idle shares of the
profiled window; writes the same as JSON to --out. Fails without a CUDA
device.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np
import torch

from .timing import card_name

BATCH, STEPS = 512, 5
GROUPS = (
    ("gat_block_fwd", "K5 forward (gat_block_fwd)"),
    ("gat_block_bwd", "K5 backward (gat_block_bwd)"),
    ("lbf_rows_fwd", "K4 forward, row-local (lbf_rows_fwd)"),
    ("lbf_sa_fwd", "K4 forward, self-attention (lbf_sa_fwd)"),
    ("lbf_out_bwd", "K4 backward, L3 and D (lbf_out_bwd)"),
    ("lbf_sa_bwd_dq", "K4 backward, dq2 (lbf_sa_bwd_dq)"),
    ("lbf_sa_bwd_dkv", "K4 backward, dk2/dv2 (lbf_sa_bwd_dkv)"),
    ("lbf_rows_bwd", "K4 backward, row-local (lbf_rows_bwd)"),
    ("lbf_joints_bwd", "K4 backward, joints (lbf_joints_bwd)"),
    ("reduce_partials", "K4 + K5 gradient-partial reduction"),
)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _is_kernel(evt) -> bool:
    """A device-side kernel or copy; not a user-annotated range (such as
    the optimizer's), whose device time repeats its kernels'."""
    kind = str(getattr(evt, "device_type", ""))
    return ("CUDA" in kind and _device_us(evt) > 0
            and not getattr(evt, "is_user_annotation", False))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", type=int, default=2, choices=(1, 2))
    ap.add_argument("--out", default="build/profile_train.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    from gator_tpu_torch import losses
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.train import (Adam, TrainState, make_gat_train_step,
                                       make_gator_train_step)

    dev = torch.device("cuda")
    dtype = torch.bfloat16
    card = card_name()
    assets = build_assets("human36", data_dirs=[],
                          synthetic_vertex_num=6890, seed=0)
    model = build_gator(GatorSpec.from_assets(assets), seed=11, device=dev)
    b, j = BATCH, model.spec.gat.num_joint
    v = model.spec.mdr.full_num
    rng = np.random.default_rng(1)
    if args.stage == 2:
        arrays = {"pose2d": rng.normal(size=(b, j, 2)),
                  "mesh": rng.normal(size=(b, v, 3)) * 0.1,
                  "lift_pose3d": rng.normal(size=(b, j, 3)) * 100,
                  "reg_pose3d": rng.normal(size=(b, 17, 3)) * 100,
                  "mesh_valid": np.ones((b, v, 1)),
                  "lift_valid": np.ones((b, j, 1)),
                  "reg_valid": np.ones((b, 17, 1))}
        state = TrainState(model, Adam(model.parameters(), lr=1e-4))
        step_fn = make_gator_train_step(
            model.spec, assets.faces, assets.j_regressor_h36m,
            losses.LossWeights(), dtype=dtype)
        extra = (7, 1.0)
    else:
        gat = model.pose_lifter
        arrays = {"pose2d": rng.normal(size=(b, j, 2)),
                  "joint_cam": rng.normal(0, 100, size=(b, j, 3)),
                  "joint_valid": np.ones((b, j, 1))}
        state = TrainState(gat, Adam(gat.parameters(), lr=1e-4))
        step_fn = make_gat_train_step(gat.spec, dtype=dtype)
        extra = (7,)
    batch = {k: torch.from_numpy(a.astype(np.float32)).to(dev)
             for k, a in arrays.items()}

    def step():
        return step_fn(state, batch, *extra)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    groups = collections.OrderedDict((label, 0.0) for _, label in GROUPS)
    plain = collections.Counter()
    optimizer_us = 0.0
    for evt in prof.key_averages():
        if (getattr(evt, "is_user_annotation", False)
                and evt.key.startswith("Optimizer.step")
                and "CUDA" in str(getattr(evt, "device_type", ""))):
            optimizer_us += _device_us(evt)
        if not _is_kernel(evt):
            continue
        us = _device_us(evt)
        for key, label in GROUPS:
            if key in evt.key:
                groups[label] += us
                break
        else:
            plain[evt.key[:90]] += us
    n = STEPS
    kernel_ms = {k: v / 1e3 / n for k, v in groups.items()}
    plain_ms = sum(plain.values()) / 1e3 / n
    busy = sum(kernel_ms.values()) + plain_ms
    step_ms = window_ms / n
    result = {
        "card": card, "stage": args.stage, "batch": b, "dtype": "bfloat16",
        "joint_set": "human36",
        "host_step_ms_median": float(np.median(times)),
        "host_step_ms_all": times,
        "profiled_step_ms": step_ms,
        "device_ms_per_step": {**kernel_ms, "plain torch (all other kernels)":
                               plain_ms},
        # the optimizer's range on the device (its kernels are part of the
        # plain-torch total)
        "optimizer_device_ms_per_step": optimizer_us / 1e3 / n,
        "device_busy_ms_per_step": busy,
        # against the profiled window, and against the unprofiled step
        "device_idle_share": max(0.0, 1.0 - busy / step_ms),
        "device_idle_share_unprofiled": max(
            0.0, 1.0 - busy / float(np.median(times))),
        "plain_top": [(name, us / 1e3 / n)
                      for name, us in plain.most_common(12)],
    }
    print(f"stage-{args.stage} step, B={b}, bf16, human36, "
          f"on {card}: {result['host_step_ms_median']:.3f} ms on the host "
          f"clock (median of {n}); profiled {step_ms:.3f} ms per step")
    for label, ms in result["device_ms_per_step"].items():
        print(f"  {ms:9.3f} ms  {100 * ms / step_ms:5.1f} %  {label}")
    print(f"  device busy {busy:.3f} ms per step, idle share "
          f"{result['device_idle_share']:.3f} of the profiled window, "
          f"{result['device_idle_share_unprofiled']:.3f} of the unprofiled "
          f"step")
    print(f"  of the plain-torch time, the optimizer step: "
          f"{result['optimizer_device_ms_per_step']:.3f} ms")
    print("  largest plain-torch kernels:")
    for name, ms in result["plain_top"]:
        print(f"    {ms:8.3f} ms  {name}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
