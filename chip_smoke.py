#!/usr/bin/env python3
"""Drive the PyTorch port (gator_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each:
  1. card: name and power limit (nvidia-smi), CUDA version; TF32 off;
  2. build: compile K1 (csrc/gat_trunk.cu) and K2 (csrc/lbf_stack.cu);
  3. K1 against its plain version, full width, B=64, J=17 and 19;
  4. K2 against its plain version, B=16, 431 vertices, J=17 and 19;
  5. end to end: full-width synthetic 6890-vertex model, kernel path
     against the plain path (f32 within 1e-4 m; bf16 within 5e-2 m of f32);
  6. the serve CLI on 300 seeded COCO poses: this is the main path the
     launch counts are read from (reset just before, read just after);
  7. times at B=2048, bf16: K1, K2 and the whole serving call, each kernel
     path beside its plain version (CUDA events, median of 5).
Then a JSON line with each kernel's numbers, and as the last line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and no result line is printed. Without a CUDA device the
script fails at once; there is no CPU fallback.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# the JAX package's own bf16-vs-f32 mesh difference on a TPU v5e
# (BENCH_r05.json kernel_max_abs_diff_bf16): a TPU figure, shown for scale
TPU_BF16_MESH_ERR = 0.012410640716552734
KERNELS = {
    "gat_trunk": ("gator_tpu_torch/csrc/gat_trunk.cu",
                  "gator_tpu/nn/pallas_gat.py:266"),
    "lbf_stack": ("gator_tpu_torch/csrc/lbf_stack.cu",
                  "gator_tpu/nn/pallas_mdr.py:352"),
}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def time_ms(torch, fn, reps=5, calls=3):
    """Median ms per call over `reps` runs of `calls` calls (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    torch.set_grad_enabled(False)
    sys.path.insert(0, ROOT)
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.cli import serve as serve_cli
    from gator_tpu_torch.data import processing
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.nn import (cuda_lib, fold_stack_weights,
                                    fold_trunk_weights, gat_trunk,
                                    gat_trunk_ref, lbf_stack, lbf_stack_ref)
    from gator_tpu_torch.serving import make_serving_fn

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16

    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(1, f"card {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}; TF32 off")

    # 2. build
    for name in KERNELS:
        t0 = time.perf_counter()
        path, nvcc_s = cuda_lib.build(name)
        say(2, f"{name}: {os.path.relpath(path, ROOT)} (nvcc {nvcc_s:.1f} s,"
               f" {time.perf_counter() - t0:.1f} s in all)")

    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    models = {}
    for joint_set, alpha in (("human36", False), ("coco", True)):
        assets = build_assets(joint_set, data_dirs=[],
                              synthetic_vertex_num=6890, seed=0)
        model = build_gator(GatorSpec.from_assets(assets, alpha=alpha),
                            seed=1, device=dev)
        if not alpha:
            bn = model.pose2mesh.bias_norm
            bn.running_mean.copy_(randn(*bn.running_mean.shape) * 0.5)
            bn.running_var.copy_(torch.rand(*bn.running_var.shape,
                                            generator=gen).to(dev) * 1.5
                                 + 0.5)
        models[joint_set] = model
    full_v = models["human36"].spec.mdr.full_num
    coarse_v = models["human36"].spec.mdr.coarse_num
    check((full_v, coarse_v) == (6890, 431), "full-width assets")

    errs = {name: 0.0 for name in KERNELS}

    # 3. K1 against its plain version
    for joint_set, model in models.items():
        gat = model.pose_lifter
        j = gat.spec.num_joint
        bias = gat.get_hop_path_encoding().float()
        masks = gat.blocks[0].x_feat.masks
        x = randn(64, j, 128)
        for dt in (f32, bf16):
            w = fold_trunk_weights(gat.blocks, dt, dev)
            got = gat_trunk(x.to(dt), bias, masks, w, 8)
            ref = gat_trunk_ref(x.to(dt), bias, masks, w, 8)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            check(np.isfinite(err), f"K1 {dt} finite")
            if dt == f32:
                check(err <= 1e-4, f"K1 f32 J={j} err {err} <= 1e-4")
                errs["gat_trunk"] = max(errs["gat_trunk"], err)
            say(3, f"K1 gat_trunk J={j} B=64 {str(dt)[6:]}: max abs err "
                   f"{err:.3e} vs plain" + (" (bar 1e-4)" if dt == f32
                                            else " (reported)"))

    # 4. K2 against its plain version
    for joint_set, model in models.items():
        mdr = model.pose2mesh
        j = mdr.spec.num_joint
        verts, joints = randn(16, coarse_v, 64), randn(16, j, 64)
        for dt in (f32, bf16):
            w = fold_stack_weights(mdr, dt, dev)
            got = lbf_stack(verts.to(dt), joints.to(dt), w, 2)
            ref = lbf_stack_ref(verts.to(dt), joints.to(dt), w, 2)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            check(np.isfinite(err), f"K2 {dt} finite")
            if dt == f32:
                check(err <= 1e-4, f"K2 f32 J={j} err {err} <= 1e-4")
                errs["lbf_stack"] = max(errs["lbf_stack"], err)
            say(4, f"K2 lbf_stack J={j} B=16 Nv={coarse_v} {str(dt)[6:]}: "
                   f"max abs err {err:.3e} vs plain"
                   + (" (bar 1e-4)" if dt == f32 else " (reported)"))

    # 5. end to end, kernel path against plain path
    for joint_set, model in models.items():
        j = model.spec.gat.num_joint
        pose = randn(256, j, 2)
        plain = make_serving_fn(model, f32, use_kernels=False)
        ref_mesh, ref_pose = plain(pose)
        gat_trunk.launches = lbf_stack.launches = 0
        mesh32, pose32 = make_serving_fn(model, f32)(pose)
        mesh16, _ = make_serving_fn(model, bf16)(pose)
        torch.cuda.synchronize()
        check(gat_trunk.launches > 0 and lbf_stack.launches > 0,
              "both kernels launched in the end-to-end run")
        check(mesh32.shape == (256, full_v, 3), "mesh shape")
        e32, p32 = max_err(mesh32, ref_mesh), max_err(pose32, ref_pose)
        e16 = max_err(mesh16, ref_mesh)
        check(e32 <= 1e-4, f"e2e f32 mesh err {e32} <= 1e-4 m")
        check(np.isfinite(e16) and e16 <= 5e-2,
              f"e2e bf16 mesh err {e16} <= 5e-2 m")
        say(5, f"{joint_set} alpha={model.spec.mdr.alpha} B=256: kernel "
               f"f32 vs plain f32 mesh {e32:.3e} m, pose3d {p32:.3e} mm; "
               f"kernel bf16 vs plain f32 mesh {e16:.4f} m (bar 5e-2; the "
               f"JAX package's bf16 figure on a TPU v5e: "
               f"{TPU_BF16_MESH_ERR:.4f} m)")

    # 6. the serve CLI, the main path whose launches are counted
    rng = np.random.default_rng(0)
    poses = np.concatenate([rng.uniform(50, 450, size=(300, 17, 2)),
                            rng.uniform(0.3, 1.0, size=(300, 17, 1))],
                           axis=2).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "poses.npy"), os.path.join(tmp, "m.npy")
        np.save(src, poses)
        gat_trunk.launches = lbf_stack.launches = 0
        served = serve_cli.main(["--input_poses", src, "--joint_set", "coco",
                                 "--output", out,
                                 "--batch_size", "256"])
        torch.cuda.synchronize()
        launches = {"gat_trunk": gat_trunk.launches,
                    "lbf_stack": lbf_stack.launches}
        meshes = np.load(out)
    check(meshes.shape == (300, full_v, 3), f"CLI meshes {meshes.shape}")
    check(np.isfinite(meshes).all(), "CLI meshes finite")
    check(all(n > 0 for n in launches.values()),
          f"each kernel launched on the main path: {launches}")
    coco = build_assets("coco")
    cli_model = build_gator(GatorSpec.from_assets(coco), seed=0, device=dev)
    pose2d = processing.batch_crop_and_normalize(
        processing.add_pelvis_neck_scores(
            poses, list(coco.joint_set.joints_name))[..., :2])
    ref, _ = make_serving_fn(cli_model, f32, use_kernels=False)(
        torch.from_numpy(pose2d).to(dev))
    e_cli = float(np.abs(meshes - ref.float().cpu().numpy()).max())
    check(e_cli <= 5e-2, f"CLI bf16 meshes vs plain f32 {e_cli} <= 5e-2 m")
    check(served["meshes"].shape == meshes.shape, "CLI return value")
    say(6, f"serve CLI: 300 coco poses -> meshes {list(meshes.shape)}, "
           f"finite, max {e_cli:.4f} m from the plain f32 path; launches "
           f"{launches}")

    # 7. times at the main path's shapes, B=2048, bf16
    model = models["human36"]
    gat, mdr = model.pose_lifter, model.pose2mesh
    b = 2048
    tw = fold_trunk_weights(gat.blocks, bf16, dev)
    sw = fold_stack_weights(mdr, bf16, dev)
    bias = gat.get_hop_path_encoding().float()
    masks = gat.blocks[0].x_feat.masks
    x = randn(b, 17, 128).to(bf16)
    verts, joints = randn(b, coarse_v, 64).to(bf16), randn(b, 17, 64).to(
        bf16)
    pose = randn(b, 17, 2)
    serve_k = make_serving_fn(model, bf16)
    serve_p = make_serving_fn(model, bf16, use_kernels=False)
    ms = {
        "gat_trunk": time_ms(torch, lambda: gat_trunk(x, bias, masks, tw,
                                                      8)),
        "gat_trunk_plain": time_ms(torch, lambda: gat_trunk_ref(
            x, bias, masks, tw, 8)),
        "lbf_stack": time_ms(torch, lambda: lbf_stack(verts, joints, sw, 2)),
        "lbf_stack_plain": time_ms(torch, lambda: lbf_stack_ref(
            verts, joints, sw, 2)),
        "serve": time_ms(torch, lambda: serve_k(pose)),
        "serve_plain": time_ms(torch, lambda: serve_p(pose)),
    }
    for name in ("gat_trunk", "lbf_stack", "serve"):
        k, p = ms[name], ms[name + "_plain"]
        say(7, f"{name} B={b} bf16 on {card}: kernel path {k:.3f} ms "
               f"({b / k * 1e3:,.0f} poses/s), plain {p:.3f} ms "
               f"({b / p * 1e3:,.0f} poses/s)")

    check("jax" not in sys.modules and "gator_tpu" not in sys.modules,
          "no JAX imported")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src_path,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[name], "ms": ms[name],
         "plain_ms": ms[name + "_plain"]}
        for name, (src_path, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
