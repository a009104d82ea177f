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

--model hmr2 serves HMR 2.0 (`models.hmr2`) instead: --input_poses holds
[N, 3, 256, 256] person crops already normalised as HMR 2.0's data hands
them to the model (RGB, ImageNet's mean and std), --batch_size counts
crops, --output gets [N, 6890, 3] meshes, --joints_output the [N, 24, 3]
SMPL joints and --cam_output the [N, 3] camera translations (focal length
5000), in metres; --obj_dir writes every --obj_every-th mesh.
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
from ..models import GatorSpec, build_gator, build_hmr2, build_motionbert_mesh
from ..parallel import launched, main_print, pad_to_multiple
from ..serving import make_serving_fn, make_sharded_serving_fn
from ..train.checkpoint import load_weights
from ..vis import save_obj


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GATOR batch serving (PyTorch)")
    p.add_argument("--input_poses", type=str, required=True,
                   help=".npy of [N, 17, 2or3] pixel keypoints (with "
                        "--model motionbert_mesh: [N, T, 17, 2or3] "
                        "normalised clips; with --model hmr2: [N, 3, 256, "
                        "256] normalised crops)")
    p.add_argument("--model", type=str, default="gator",
                   choices=("gator", "motionbert_mesh", "hmr2"))
    p.add_argument("--joint_set", type=str, default="coco",
                   choices=("coco", "human36"))
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--output", type=str, default="meshes.npy")
    p.add_argument("--joints_output", type=str, default=None,
                   help="optional .npy for the lifted 3D joints")
    p.add_argument("--cam_output", type=str, default=None,
                   help="optional .npy for HMR 2.0's camera translations")
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

    v, j = spec.mdr.full_num, spec.gat.num_joint
    (meshes, joints3d), dt = _serve_rows(fn, pose2d, ((v, 3), (j, 3)),
                                         batch_size, ranks, device)
    say(_served(f"{n} poses", n, "poses", dt, device, ranks, dtype,
                f"batch {batch_size}"))
    _write(world, ((output, meshes, f"[{n}, {v}, 3] (meters)", "meshes"),
                   (joints_output, joints3d, "(mm)", "3D joints")),
           obj_dir, meshes[::max(1, obj_every)], obj_every, assets.faces,
           "mesh")
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


def _serve_rows(fn, rows: np.ndarray, shapes, batch_size: int, ranks: int,
                device):
    """`fn` over `rows` in chunks of `batch_size`, each padded to a
    multiple of `ranks` -> (one float32 array [N, *shape] for each of
    fn's outputs, in order, of `shapes`; the seconds taken, host clock,
    transfers included)."""
    n = len(rows)
    outs = tuple(np.empty((n,) + tuple(s), np.float32) for s in shapes)
    t0 = time.perf_counter()
    for lo in range(0, n, batch_size):
        chunk, real = pad_to_multiple(rows[lo:lo + batch_size], ranks)
        for dst, got in zip(outs, fn(torch.from_numpy(chunk).to(device))):
            dst[lo:lo + real] = got[:real].float().cpu().numpy()
    return outs, time.perf_counter() - t0


def _served(what: str, count: int, unit: str, dt: float, device, ranks: int,
            dtype: str, batch: str) -> str:
    """The rate line: `count` `unit` served in `dt` seconds."""
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return (f"served {what} in {dt:.2f}s ({count / max(dt, 1e-9):,.0f} "
            f"{unit}/s on {name}"
            + (f" x {ranks} ranks" if ranks > 1 else "")
            + f", {dtype}, {batch}, host clock incl. transfers)")


def _write(world, saves, obj_dir, obj_meshes, obj_every: int, faces,
           obj_name: str) -> None:
    """On rank 0 alone: each (path, array, note, what) of `saves` whose
    path is set to .npy, and `obj_meshes` (every `obj_every`-th row's
    mesh) as .obj files under `obj_dir`."""
    if world is not None and not world.is_main:
        return
    for path, arr, note, what in saves:
        if path:
            np.save(path, arr)
            print(f"{what} -> {path} {note}")
    if obj_dir:
        os.makedirs(obj_dir, exist_ok=True)
        for k, mesh in enumerate(obj_meshes):
            save_obj(mesh, faces, osp.join(
                obj_dir, f"{obj_name}_{k * max(1, obj_every):06d}.obj"))
        print(f"objs -> {obj_dir}")


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
    (meshes, joints3d), dt = _serve_rows(
        fn, clips, ((t, v0, 3), (t, 17, 3)), batch_size, ranks, device)
    say(_served(f"{n} clips of {t} frames", n * t, "frames", dt, device,
                ranks, dtype, f"batch {batch_size} clips"))
    _write(world, ((output, meshes, f"[{n}, {t}, {v0}, 3] (meters)",
                    "meshes"),
                   (joints_output, joints3d, "(meters)", "3D joints")),
           obj_dir, meshes[::max(1, obj_every), 0], obj_every, assets.faces,
           "clip")
    return {"meshes": meshes, "joints3d": joints3d}


def run_serve_crops(crop_path: str, weights: str | None = None,
                    output: str = "meshes.npy",
                    joints_output: str | None = None,
                    cam_output: str | None = None,
                    obj_dir: str | None = None, obj_every: int = 100,
                    batch_size: int = 256, dtype: str = "bfloat16",
                    device: str = "cuda", assets=None, world=None):
    """Serve HMR 2.0 over normalised crops (module docstring) ->
    {"meshes" [N, V0, 3], "joints3d" [N, 24, 3], "cam_t" [N, 3]}, in
    metres (every rank returns the whole arrays)."""
    say = main_print(world)
    device = world.device if world is not None else torch.device(device)
    assets = assets or build_assets("human36")
    model = build_hmr2(assets, seed=0, device="cpu")
    s = model.spec.image_size
    crops = np.load(crop_path).astype(np.float32)
    if crops.ndim != 4 or crops.shape[1:] != (3, s, s):
        raise ValueError(f"{crop_path}: crops must be [N, 3, {s}, {s}], not "
                         f"{crops.shape}")
    fn, batch_size, ranks = _serving(model, weights, device, world, dtype,
                                     batch_size)
    n = len(crops)
    v0 = assets.smpl.vertex_num
    (meshes, joints3d, cam_t), dt = _serve_rows(
        fn, crops, ((v0, 3), (24, 3), (3,)), batch_size, ranks, device)
    say(_served(f"{n} crops", n, "crops", dt, device, ranks, dtype,
                f"batch {batch_size}"))
    _write(world, ((output, meshes, f"[{n}, {v0}, 3] (meters)", "meshes"),
                   (joints_output, joints3d, "(meters)", "SMPL joints"),
                   (cam_output, cam_t, "(meters)", "camera translations")),
           obj_dir, meshes[::max(1, obj_every)], obj_every, assets.faces,
           "crop")
    return {"meshes": meshes, "joints3d": joints3d, "cam_t": cam_t}


def main(argv=None):
    """The CLI; under torchrun, one rank of a data-parallel run."""
    a = parse_args(argv)
    dtype = "float32" if a.f32 else a.dtype
    with launched(a.device) as world:
        if a.model == "hmr2":
            return run_serve_crops(a.input_poses, a.weights, a.output,
                                   a.joints_output, a.cam_output, a.obj_dir,
                                   a.obj_every, a.batch_size, dtype,
                                   a.device, world=world)
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
