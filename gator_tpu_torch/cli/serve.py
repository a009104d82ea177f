"""Batch serving CLI: 2D poses (.npy) -> SMPL meshes (.npy [, .obj]), on one
device.

Loads [N, 17, 2-or-3] raw pixel keypoints, preprocesses them with the
datasets' crop/normalize, and runs the serving path
(`gator_tpu_torch.serving.make_serving_fn`) in chunks of --batch_size.

    python -m gator_tpu_torch.cli.serve --input_poses poses.npy \
        --joint_set coco --output meshes.npy

--weights takes a state dict saved with torch.save (a bare dict, or the
reference's {"model_state_dict": ...} layout, with any DataParallel
"module." prefix; `train.checkpoint.load_weights`), or a directory of
checkpoints; a `gator_tpu` orbax checkpoint goes through
`tools/jax_checkpoint_to_torch.py` first. Without it the weights are random
(seed 0). --obj_dir also writes every --obj_every-th mesh as .obj; --f32 is
--dtype float32. The default device is cuda; there is no fallback to the
CPU.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import numpy as np
import torch

from ..assets import build_assets
from ..data import processing
from ..models import GatorSpec, build_gator
from ..serving import make_serving_fn
from ..train.checkpoint import load_weights
from ..vis import save_obj


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GATOR batch serving (PyTorch)")
    p.add_argument("--input_poses", type=str, required=True,
                   help=".npy of [N, 17, 2or3] pixel keypoints")
    p.add_argument("--joint_set", type=str, default="coco",
                   choices=("coco", "human36"))
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--output", type=str, default="meshes.npy")
    p.add_argument("--joints_output", type=str, default=None,
                   help="optional .npy for the lifted 3D joints")
    p.add_argument("--obj_dir", type=str, default=None,
                   help="also dump every --obj_every-th mesh as .obj")
    p.add_argument("--obj_every", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--f32", action="store_true",
                   help="alias for --dtype float32")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def run_serve(pose_path: str, joint_set: str = "coco",
              weights: str | None = None, output: str = "meshes.npy",
              joints_output: str | None = None,
              obj_dir: str | None = None, obj_every: int = 100,
              batch_size: int = 256, dtype: str = "bfloat16",
              device: str = "cuda", assets=None):
    device = torch.device(device)
    assets = assets or build_assets(joint_set)
    spec = GatorSpec.from_assets(assets)
    model = build_gator(spec, seed=0, device="cpu")
    if weights:
        load_weights(model, weights)
    else:
        print("WARNING: serving randomly initialized weights")
    model = model.to(device)
    fn = make_serving_fn(model, dtype=getattr(torch, dtype))

    poses = np.load(pose_path).astype(np.float32)
    poses = poses.reshape(len(poses), 17, -1)
    if poses.shape[-1] == 2:
        poses = np.concatenate(
            [poses, np.ones(poses.shape[:2] + (1,), np.float32)], axis=-1)
    if joint_set == "coco":
        poses = processing.add_pelvis_neck_scores(
            poses, list(assets.joint_set.joints_name))
    n = len(poses)
    pose2d = processing.batch_crop_and_normalize(
        poses[..., :2], assets.joint_set,
        processing.ProcessOptions(is_train=False, input_joint_name=joint_set),
        np.zeros(n, np.int64), np.zeros(n, np.float32))

    meshes = np.empty((n, spec.mdr.full_num, 3), np.float32)
    joints3d = np.empty((n, spec.gat.num_joint, 3), np.float32)
    t0 = time.perf_counter()
    for lo in range(0, n, batch_size):
        chunk = torch.from_numpy(pose2d[lo:lo + batch_size]).to(device)
        mesh, pose3d = fn(chunk)
        meshes[lo:lo + len(chunk)] = mesh.float().cpu().numpy()
        joints3d[lo:lo + len(chunk)] = pose3d.float().cpu().numpy()
    dt = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"served {n} poses in {dt:.2f}s ({n / max(dt, 1e-9):,.0f} "
          f"poses/s on {name}, {dtype}, batch {batch_size}, "
          "host clock incl. transfers)")

    np.save(output, meshes)
    print(f"meshes -> {output}  [{n}, {spec.mdr.full_num}, 3] (meters)")
    if joints_output:
        np.save(joints_output, joints3d)
        print(f"3D joints -> {joints_output} (mm)")
    if obj_dir:
        os.makedirs(obj_dir, exist_ok=True)
        for i in range(0, n, max(1, obj_every)):
            save_obj(meshes[i], assets.faces,
                     osp.join(obj_dir, f"mesh_{i:06d}.obj"))
        print(f"objs -> {obj_dir}")
    return {"meshes": meshes, "joints3d": joints3d}


def main(argv=None):
    a = parse_args(argv)
    return run_serve(a.input_poses, a.joint_set, a.weights, a.output,
                     a.joints_output, a.obj_dir, a.obj_every, a.batch_size,
                     "float32" if a.f32 else a.dtype, a.device)


if __name__ == "__main__":
    main()
