"""Where the in-step GT synthesis of the `full` and `on` input modes spends
its time, on one CUDA device (counterpart of tools/profile_gt_synth.py):

    python -m gator_tpu_torch.tools.profile_gt_synth [--batch 512]
        [--out build/profile_gt_synth.json] [--device cpu]

On the full-width synthetic human36 model (seeded random weights) and a
synthetic SMPL dataset of max(2B, 1024) rows (flip and rotation on), at
B=--batch in bf16 on K4/K5:
  * the `full` step (`data/device_pipeline.with_device_input_pipeline`:
    SMPL forward, fit gate and input assembly from index-only batches)
    against the bare step on pre-made tensors, and what the pipeline adds;
  * the same for the `on` step (`train.with_gt_synthesis`, from the raw
    SMPL and camera parameters);
  * the parts alone: `GtSynthesizer.smpl_mesh_cam` in full; the Rodrigues
    rotations and a per-joint sequential kinematic chain (the JAX tool's
    comparison point; `bodymodel/smpl.smpl_forward` walks the tree a level
    at a time); `fitting_error`; the input assembly (`crop_normalize_gt`
    and `j3d_augment`).
Each: device ms, kernel launches and idle share (torch.profiler) and host
ms (median of synchronised calls). Writes them to --out. Without a CUDA
device it fails unless --device cpu is given (then host ms only, at
--vertex_num and --depth the caller picks).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

SEED = 0


def sequential_chain(params, pose: torch.Tensor):
    """Rodrigues rotations, then the kinematic chain one joint at a time
    from the rest joints of the template -> (global rotations [B, 24, 3,
    3], joint locations [B, 24, 3])."""
    from ..bodymodel.rotations import axis_angle_to_rotmat
    b = pose.shape[0]
    nj = len(params.parents)
    rotm = axis_angle_to_rotmat(pose.reshape(b, nj, 3))
    rest = torch.einsum("jv,vc->jc", params.j_regressor,
                        params.v_template).expand(b, nj, 3)
    rots, locs = [rotm[:, 0]], [rest[:, 0]]
    for j in range(1, nj):
        p = params.parents[j]
        off = rest[:, j] - rest[:, p]
        rots.append((rots[p][..., :, :, None]
                     * rotm[:, j][..., None, :, :]).sum(-2))
        locs.append(locs[p] + (rots[p] * off[..., None, :]).sum(-1))
    return torch.stack(rots, 1), torch.stack(locs, 1)


def setup(b, device, vertex_num=6890, depth=6):
    """The model, its state, the three steps (bare, full, on), their
    batches and the synthesis tables on `device`."""
    from .. import losses
    from ..assets import build_assets
    from ..data import processing
    from ..data.device_pipeline import with_device_input_pipeline
    from ..data.gt_synth import GtSynthesizer
    from ..data.synthetic import SyntheticDataset
    from ..models import GatorSpec, build_gator
    from ..train import (Adam, TrainState, make_gator_train_step,
                         with_gt_synthesis)

    dev = torch.device(device)
    assets = build_assets("human36", data_dirs=[],
                          synthetic_vertex_num=vertex_num, seed=0)
    spec = GatorSpec.from_assets(assets, depth=depth)
    synth = GtSynthesizer(assets, dev)
    opts = processing.ProcessOptions(is_train=True, flip_enabled=True,
                                     rotate_factor=30.0)
    ds = SyntheticDataset(assets, opts, n=max(2 * b, 1024), seed=0,
                          synthesizer=synth)
    model = build_gator(spec, seed=0, device=dev)
    state = TrainState(model, Adam(model.parameters(), lr=1e-4))
    step = make_gator_train_step(spec, assets.faces, assets.j_regressor_h36m,
                                 losses.LossWeights(), dtype=torch.bfloat16)
    rows = np.arange(b) % len(ds)
    idx_batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 ds.make_index_batch(rows, np.random.default_rng(0)).items()}
    rng = np.random.default_rng(1)
    v = spec.mdr.full_num
    bare = {
        "pose2d": rng.normal(size=(b, 17, 2)),
        "mesh": rng.normal(size=(b, v, 3)) * 0.1,
        "lift_pose3d": rng.normal(size=(b, 17, 3)),
        "reg_pose3d": rng.normal(size=(b, 17, 3)),
        "mesh_valid": np.ones((b, v, 1)),
        "lift_valid": np.ones((b, 17, 1)),
        "reg_valid": np.ones((b, 17, 1)),
    }
    bare = {k: torch.as_tensor(a, dtype=torch.float32, device=dev)
            for k, a in bare.items()}
    return {
        "synth": synth, "ds": ds, "opts": opts, "state": state,
        "bare_step": step, "bare": bare, "idx_batch": idx_batch,
        "full_step": with_device_input_pipeline(
            step, synth, ds.table, ds.joint_set, opts, opts.fitting_thr),
        "on_step": with_gt_synthesis(step, synth, opts.fitting_thr),
        "raw": ds.make_raw_batch(rows, np.random.default_rng(0)),
    }


def parts(s) -> dict:
    """The synthesis parts alone, each a function of no argument on the
    rows of the index batch -> its outputs."""
    from ..data.device_pipeline import (_flip_perm, crop_normalize_gt,
                                        j3d_augment)
    synth, ds, b = s["synth"], s["ds"], s["idx_batch"]
    dev = synth.device
    t = ds.table
    idx = b["idx"].long()

    def tab(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)[idx]

    pose, shape, trans = tab(t.pose), tab(t.shape), tab(t.trans)
    cam_r, cam_t, jc = tab(t.cam_r), tab(t.cam_t), tab(t.joint_cam_h36m)
    ji = tab(t.joint_img_h36m)[..., :2]
    perm = torch.as_tensor(_flip_perm(ds.joint_set.joint_num,
                                      ds.joint_set.flip_pairs), device=dev)
    mesh = torch.ones(len(idx), synth.params["neutral"].v_template.shape[0],
                      3, device=dev)
    return {
        "smpl_mesh_cam (full)": lambda: synth.smpl_mesh_cam(
            pose, shape, trans, cam_r, cam_t, "neutral"),
        "rodrigues + sequential chain": lambda: sequential_chain(
            synth.params["neutral"], pose),
        "fitting_error": lambda: synth.fitting_error(jc - jc[:, :1], mesh),
        "input assembly (crop + j3d)": lambda: (
            crop_normalize_gt(ji, perm, s["opts"].input_shape, b["flips"],
                              b["rots"]),
            j3d_augment(jc, perm, b["flips"], b["rots"])),
    }


def run(b=512, device="cuda", vertex_num=6890, depth=6) -> dict:
    from .timing import measure
    s = setup(b, device, vertex_num, depth)
    cuda = torch.device(device).type == "cuda"

    def profile(fn):
        return measure(fn, cuda)

    state, edge = s["state"], 1.0
    steps = {
        "bare step (pre-made tensors)": lambda: s["bare_step"](
            state, s["bare"], SEED, edge),
        "full step (device pipeline)": lambda: s["full_step"](
            state, s["idx_batch"], SEED, edge),
        "on step (with_gt_synthesis)": lambda: s["on_step"](
            state, s["raw"], SEED, edge),
    }
    with torch.enable_grad():
        res = {"steps": {n: profile(f) for n, f in steps.items()}}
    bare = res["steps"]["bare step (pre-made tensors)"]
    res["pipeline_adds"] = {}
    for mode, name in (("full", "full step (device pipeline)"),
                       ("on", "on step (with_gt_synthesis)")):
        got = res["steps"][name]
        res["pipeline_adds"][mode] = {
            k: (None if got[k] is None else got[k] - bare[k])
            for k in ("host_ms", "device_ms")}
    with torch.no_grad():
        res["parts"] = {n: profile(f) for n, f in parts(s).items()}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--vertex_num", type=int, default=6890)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--out", default="build/profile_gt_synth.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_gt_synth: no CUDA device")
    card = None
    if args.device == "cuda":
        from .timing import card_name
        card = card_name()
    res = run(args.batch, args.device, args.vertex_num, args.depth)
    res.update(card=card, device=args.device, batch=args.batch,
               dtype="bfloat16", vertex_num=args.vertex_num,
               depth=args.depth)
    print(f"in-step GT synthesis, B={args.batch} bf16, on "
          f"{card or 'the CPU (host clock)'}, per call:")
    for group in ("steps", "parts"):
        for name, p in res[group].items():
            dev = ("" if p["device_ms"] is None else
                   f"{p['device_ms']:9.3f} ms device  "
                   f"{p['launches']:6.0f} launches  idle "
                   f"{p['idle_share']:.3f}  ")
            print(f"  {p['host_ms']:9.3f} ms host  {dev}{name}")
    for mode, add in res["pipeline_adds"].items():
        dev = ("" if add["device_ms"] is None
               else f", {add['device_ms']:.3f} ms device")
        print(f"  the {mode} pipeline adds {add['host_ms']:.3f} ms host"
              f"{dev} to the bare step")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print("->", args.out)
    return res


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
