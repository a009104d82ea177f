"""Batch serving CLI: 2D poses (.npy) -> SMPL meshes (.npy [, .obj]), on one
card or sharded over several (counterpart of gator_tpu/cli/serve.py).

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

On N cards, one process each:

    torchrun --standalone --nproc_per_node=N -m gator_tpu_torch.cli.serve \
        --input_poses poses.npy --joint_set coco --output meshes.npy

--batch_size is rounded up to a multiple of N (and says so), the last chunk
is padded to a multiple of N, each rank serves its rows of every chunk on
K1 and K2 (`serving.make_sharded_serving_fn`), and rank 0 alone writes the
.npy and .obj files and prints the rate with the number of ranks.

--model motionbert_mesh serves MotionBERT's mesh model
(`models.motionbert`) instead: --input_poses holds [N, T, 17, 2or3] clips
of H36M joints already normalised as MotionBERT's data hands them to the
model (x, y in a [-1, 1] crop; a missing confidence is 1), --batch_size
counts clips, --output gets [N, T, 6890, 3] meshes and --joints_output the
[N, T, 17, 3] H36M joints regressed from them, both in metres; --obj_dir
writes the first frame of every --obj_every-th clip; --joint_set is
human36.
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
from ..models import GatorSpec, build_gator, build_motionbert_mesh
from ..parallel import launched, main_print, pad_to_multiple
from ..serving import make_serving_fn, make_sharded_serving_fn
from ..train.checkpoint import load_weights
from ..vis import save_obj


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GATOR batch serving (PyTorch)")
    p.add_argument("--input_poses", type=str, required=True,
                   help=".npy of [N, 17, 2or3] pixel keypoints (with "
                        "--model motionbert_mesh: [N, T, 17, 2or3] "
                        "normalised clips)")
    p.add_argument("--model", type=str, default="gator",
                   choices=("gator", "motionbert_mesh"))
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
              device: str = "cuda", assets=None, world=None):
    """Serve the poses as `main` does -> {"meshes", "joints3d"} (every
    rank returns the whole arrays). `world`: the data-parallel ranks to
    shard each chunk over (module docstring); None is one device."""
    say = main_print(world)
    device = world.device if world is not None else torch.device(device)
    assets = assets or build_assets(joint_set)
    spec = GatorSpec.from_assets(assets)
    model = build_gator(spec, seed=0, device="cpu")
    fn, batch_size, ranks = _serving(model, weights, device, world, dtype,
                                     batch_size)

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
        chunk, real = pad_to_multiple(pose2d[lo:lo + batch_size], ranks)
        mesh, pose3d = fn(torch.from_numpy(chunk).to(device))
        meshes[lo:lo + real] = mesh[:real].float().cpu().numpy()
        joints3d[lo:lo + real] = pose3d[:real].float().cpu().numpy()
    dt = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    say(f"served {n} poses in {dt:.2f}s ({n / max(dt, 1e-9):,.0f} "
        f"poses/s on {name}"
        + (f" x {ranks} ranks" if ranks > 1 else "")
        + f", {dtype}, batch {batch_size}, host clock incl. transfers)")

    if world is None or world.is_main:
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


def _serving(model, weights, device, world, dtype: str, batch_size: int):
    """The model's weights loaded (or left random, with a warning), the
    model on `device`, and its serving function, sharded over `world`'s
    ranks when there are several -> (fn, batch size, ranks)."""
    say = main_print(world)
    if weights:
        load_weights(model, weights)
    else:
        say("WARNING: serving randomly initialized weights")
    model = model.to(device)
    if world is None or not world.grouped:
        return make_serving_fn(model, dtype=getattr(torch, dtype)), \
            batch_size, 1
    ranks = world.size
    fn = make_sharded_serving_fn(model, world, dtype=getattr(torch, dtype))
    if batch_size % ranks:
        batch_size = -(-batch_size // ranks) * ranks
        say(f"batch_size rounded up to {batch_size} (multiple of "
            f"{ranks} ranks)")
    return fn, batch_size, ranks


def run_serve_clips(clip_path: str, weights: str | None = None,
                    output: str = "meshes.npy",
                    joints_output: str | None = None,
                    obj_dir: str | None = None, obj_every: int = 100,
                    batch_size: int = 256, dtype: str = "bfloat16",
                    device: str = "cuda", assets=None, world=None):
    """Serve MotionBERT's mesh model over normalised H36M clips (module
    docstring) -> {"meshes" [N, T, V0, 3], "joints3d" [N, T, 17, 3]}, in
    metres (every rank returns the whole arrays)."""
    say = main_print(world)
    device = world.device if world is not None else torch.device(device)
    assets = assets or build_assets("human36")
    model = build_motionbert_mesh(assets, seed=0, device="cpu")
    fn, batch_size, ranks = _serving(model, weights, device, world, dtype,
                                     batch_size)
    clips = np.load(clip_path).astype(np.float32)
    if clips.ndim != 4 or clips.shape[2] != 17 or clips.shape[3] not in (2,
                                                                          3):
        raise ValueError(f"{clip_path}: clips must be [N, T, 17, 2or3], "
                         f"not {clips.shape}")
    if clips.shape[-1] == 2:
        clips = np.concatenate(
            [clips, np.ones(clips.shape[:3] + (1,), np.float32)], axis=-1)
    n, t = clips.shape[:2]
    v0 = assets.smpl.vertex_num
    meshes = np.empty((n, t, v0, 3), np.float32)
    joints3d = np.empty((n, t, 17, 3), np.float32)
    t0 = time.perf_counter()
    for lo in range(0, n, batch_size):
        chunk, real = pad_to_multiple(clips[lo:lo + batch_size], ranks)
        verts, kp3d = fn(torch.from_numpy(chunk).to(device))
        meshes[lo:lo + real] = verts[:real].cpu().numpy()
        joints3d[lo:lo + real] = kp3d[:real].cpu().numpy()
    dt = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    say(f"served {n} clips of {t} frames in {dt:.2f}s "
        f"({n * t / max(dt, 1e-9):,.0f} frames/s on {name}"
        + (f" x {ranks} ranks" if ranks > 1 else "")
        + f", {dtype}, batch {batch_size} clips, host clock incl. "
          f"transfers)")
    if world is None or world.is_main:
        np.save(output, meshes)
        print(f"meshes -> {output}  [{n}, {t}, {v0}, 3] (meters)")
        if joints_output:
            np.save(joints_output, joints3d)
            print(f"3D joints -> {joints_output} (meters)")
        if obj_dir:
            os.makedirs(obj_dir, exist_ok=True)
            for i in range(0, n, max(1, obj_every)):
                save_obj(meshes[i, 0], assets.faces,
                         osp.join(obj_dir, f"clip_{i:06d}.obj"))
            print(f"objs -> {obj_dir}")
    return {"meshes": meshes, "joints3d": joints3d}


def main(argv=None):
    """The CLI; under torchrun, one rank of a data-parallel run."""
    a = parse_args(argv)
    dtype = "float32" if a.f32 else a.dtype
    with launched(a.device) as world:
        if a.model == "motionbert_mesh":
            return run_serve_clips(a.input_poses, a.weights, a.output,
                                   a.joints_output, a.obj_dir, a.obj_every,
                                   a.batch_size, dtype, a.device,
                                   world=world)
        return run_serve(a.input_poses, a.joint_set, a.weights, a.output,
                         a.joints_output, a.obj_dir, a.obj_every,
                         a.batch_size, dtype, a.device, world=world)


if __name__ == "__main__":
    main()
