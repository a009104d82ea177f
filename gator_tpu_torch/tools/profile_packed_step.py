"""Where the time of the flagship recipe's in-step input path goes, on one
CUDA device (counterpart of tools/profile_packed_step.py).

    python -m gator_tpu_torch.tools.profile_packed_step [--batch 512]
        [--rows 4096] [--out build/profile_packed_step.json]

Builds a training `Session` on configs/gator_synthetic_flagship.yml with
the synthetic stand-ins of its Human36M + COCO + MuCo mix (`--rows` rows
each, COCO joints, detector input, flip and rotation), whose
TRAIN.gt_in_step "auto" resolves to "device", and the full-width model
with seeded random weights. Then, at B=--batch in bf16 on K4/K5, each
piece alone, three warm-up calls and five profiled (torch.profiler, CPU
and CUDA activities), in device ms per call:
  * the whole "device" step (index batch in; mesh cache off and on);
  * the step on ready tensors (the batch the wrapper assembles);
  * SMPL GT synthesis (the per-gender forward plus the row offsets);
  * the in-step 2D input (gather, crop, detector noise, flip and
    standardise), and the detector noise alone with its kernel launches;
  * the target gathers (lift augmentation, regression target, masks).
With each: its kernel launches, the host-clock ms per call (median of
five synchronised calls, unprofiled) and the device's idle share of the
profiled window; for the whole step, each step.* span (step.assemble,
step.noise, step.gt with the mesh cache off, and the inner step's) with
its host ms, launches, device ms and the idle that opens in it. Prints them and writes them as JSON to --out. Fails
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .timing import card_name, span_profile

WARMUP, REPS = 3, 5
CONFIG = "configs/gator_synthetic_flagship.yml"


def profile(fn, reps: int = REPS):
    """fn() run WARMUP times, `reps` times each synchronised on the host
    clock, then `reps` times in one profiled window (`span_profile`) ->
    {device_ms, host_ms (median, unprofiled), profiled_ms, launches,
    idle_share (the device's idle inside the profiled window), spans (the
    step.* spans' host ms, launches, device ms and idle)}, each per
    call."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    spans = span_profile(fn, reps)
    window = spans["trace"]
    return {"device_ms": window["device_ms"],
            "host_ms": float(np.median(host)),
            "profiled_ms": window["host_ms"],
            "launches": window["launches"],
            "idle_share": window["idle_ms"] / window["host_ms"],
            "spans": {k: v for k, v in spans.items()
                      if k.startswith("step.")}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--rows", type=int, default=4096,
                    help="rows of each stand-in dataset")
    ap.add_argument("--out", default="build/profile_packed_step.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_packed_step: no CUDA device")
    from gator_tpu_torch.cli.common import Session
    from gator_tpu_torch.config import load_config
    from gator_tpu_torch.data.device_noise import synthesize_pose_device
    from gator_tpu_torch.data.device_pipeline import (_flip_perm,
                                                      affine_crop,
                                                      flip_standardize,
                                                      j3d_augment)
    from gator_tpu_torch.data.packed import (gendered_smpl_verts,
                                             make_device_batch,
                                             with_packed_input_pipeline)
    from gator_tpu_torch.train import Adam

    dev = torch.device("cuda")
    card = card_name()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = load_config(os.path.join(root, CONFIG),
                      {"TRAIN": {"batch_size": args.batch}})
    sess = Session(cfg, synthetic=True, synthetic_n=args.rows, device=dev,
                   is_train=True)
    if sess.gt_in_step != "device":
        raise SystemExit(f"{CONFIG} resolved to {sess.gt_in_step!r}, "
                         "not 'device'")
    table = sess.packed_table()
    state, step = sess.make_train_step(
        lambda p: Adam(p, lr=cfg.TRAIN.lr))
    opts = sess.datasets[0].opts
    uncached = with_packed_input_pipeline(
        step.inner, table, sess.synth, sess.assets.joint_set,
        opts=opts, device_input=True, mesh_cache=False)
    b = args.batch
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in make_device_batch(
        sess.datasets[0], rng.integers(0, args.rows, b), rng).items()}
    # rows of every dataset in the mix
    batch["row"] = torch.as_tensor(rng.integers(0, len(table), b),
                                   dtype=torch.int32, device=dev)
    seed, edge = cfg.seed, 1.0

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    tbl = {"pose_eff": f32(table.pose_eff),
           "shape_eff": f32(table.shape_eff),
           "offset_m": f32(table.trans_off - table.root_mm / 1000.0),
           "joint_img_input": f32(table.joint_img_input),
           "crop_area": f32(table.crop_area),
           "joint_cam_input": f32(table.joint_cam_input),
           "reg_pose": f32(table.reg_pose),
           "mesh_valid": f32(table.mesh_valid),
           "reg_valid": f32(table.reg_valid),
           "lift_valid": f32(table.lift_valid)}
    row = batch["row"].long()
    flips, rots = batch["flips"], batch["rots"]
    jset = sess.assets.joint_set
    perm = torch.as_tensor(_flip_perm(jset.joint_num, jset.flip_pairs),
                           device=dev)
    input_shape = tuple(opts.input_shape)
    gen = torch.Generator(device=dev).manual_seed(0)
    inner = step.assemble(state, batch, seed, edge)

    def smpl():
        verts = gendered_smpl_verts(sess.synth.params,
                                    table.genders_present, None,
                                    tbl["pose_eff"][row],
                                    tbl["shape_eff"][row])
        return verts + tbl["offset_m"][row][:, None]

    def input2d():
        out = affine_crop(tbl["joint_img_input"][row], input_shape, rots)
        out = torch.cat([synthesize_pose_device(
            gen, out[:, :17], tbl["crop_area"][row]), out[:, 17:]], dim=1)
        return flip_standardize(out, perm, input_shape, flips)

    def noise():
        return synthesize_pose_device(gen, tbl["joint_img_input"][row, :17],
                                      tbl["crop_area"][row])

    def targets():
        return (j3d_augment(tbl["joint_cam_input"][row], perm, flips, rots),
                tbl["reg_pose"][row], tbl["mesh_valid"][row],
                tbl["reg_valid"][row], tbl["lift_valid"][row])

    pieces = {}
    with torch.enable_grad():
        pieces["device step, mesh cache on"] = profile(
            lambda: step(state, batch, seed, edge))
        pieces["device step, mesh cache off"] = profile(
            lambda: uncached(state, batch, seed, edge))
        pieces["step on ready tensors"] = profile(
            lambda: step.inner(state, inner, seed, edge))
    with torch.no_grad():
        pieces["SMPL GT synthesis"] = profile(smpl)
        pieces["2D input (crop, noise, flip, standardise)"] = profile(
            input2d)
        pieces["detector noise alone"] = profile(noise)
        pieces["target gathers"] = profile(targets)

    whole = pieces["device step, mesh cache on"]["device_ms"]
    result = {"card": card, "config": CONFIG, "batch": b,
              "rows": len(table), "dtype": "bfloat16",
              "mesh_cache_auto": sess._mesh_cache_on(len(table)),
              "pieces": pieces,
              "noise_share_of_step": (
                  pieces["detector noise alone"]["device_ms"] / whole)}
    print(f"flagship mix, gt_in_step=device, B={b} bf16, "
          f"{len(table)} table rows, on {card} (device ms from "
          f"torch.profiler; host ms synchronised, unprofiled; per call):")
    for name, p in pieces.items():
        print(f"  {p['device_ms']:9.3f} ms device  {p['host_ms']:9.3f} ms "
              f"host  {p['launches']:6.0f} launches  idle "
              f"{p['idle_share']:.3f}  {name}")
    print(f"  detector noise: {100 * result['noise_share_of_step']:.1f} % "
          f"of the step's device time")
    for name in ("device step, mesh cache on", "device step, mesh cache off"):
        print(f"  {name}, per span (host ms, launches, device ms, idle ms):")
        for span, f in pieces[name]["spans"].items():
            print(f"  {f['host_ms']:10.3f} {f['launches']:9.1f} "
                  f"{f['device_ms']:10.3f} {f['idle_ms']:10.3f}  {span}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
