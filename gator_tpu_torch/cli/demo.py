"""Demo CLI: one 2D pose (.npy) -> SMPL mesh (.obj) and two renders
(counterpart of gator_tpu/cli/demo.py; reference: demo/run.py:170-223).

    python -m gator_tpu_torch.cli.demo --input_pose pose.npy \
        --joint_set coco [--weights w.pth.tar --adam_fit --device cpu]

Loads a [17, 2-or-3] pose in pixels, adds pelvis and neck for the coco
joint set, runs the module-form GATOR once (the MDR vertex self-attention
on K3), fits the 3-parameter weak-perspective camera (closed-form least
squares by default, the reference's 1500 Adam steps with --adam_fit), and
writes demo_mesh.obj, demo_mesh.png and demo_pose2d.png. The PNGs need cv2;
where it is not installed the demo says which files it skipped and why,
and computes everything else the same. The default device is cuda; there
is no fallback to the CPU.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

from ..assets import build_assets
from ..data import augment, coords
from ..data.processing import add_pelvis_neck_scores
from ..models import GatorSpec, build_gator
from ..models.camera import (crop_cam_to_orig_img, fit_camera_adam,
                             fit_camera_closed_form,
                             project_weak_perspective)
from ..precision import no_tf32
from ..train.checkpoint import load_weights
from ..vis import render_mesh_overlay, save_obj, vis_2d_keypoints

VIRTUAL_CROP = 500  # square projection crop (reference: run.py:176)
IMAGES = ("demo_mesh.png", "demo_pose2d.png")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GATOR demo (PyTorch)")
    p.add_argument("--input_pose", type=str, required=True)
    p.add_argument("--input_img", type=str, default=None)
    p.add_argument("--joint_set", type=str, default="coco",
                   choices=("coco", "human36"))
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="./demo_result")
    p.add_argument("--adam_fit", action="store_true",
                   help="use the reference's 1500-step Adam camera fit")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def add_pelvis_neck_3(joints, names):
    """Pelvis/neck synthesis for [J, 3] (x, y, score) input
    (reference: demo/run.py:103-121; score = product of the parents')."""
    return add_pelvis_neck_scores(joints[None], names)[0]


def run_demo(pose_path: str, joint_set: str = "coco",
             weights: str | None = None, output_dir: str = "./demo_result",
             input_img: str | None = None, adam_fit: bool = False,
             assets=None, device: str = "cuda"):
    no_tf32()
    device = torch.device(device)
    os.makedirs(output_dir, exist_ok=True)
    assets = assets or build_assets(joint_set)
    model = build_gator(GatorSpec.from_assets(assets), seed=0, device="cpu")
    if weights:
        load_weights(model, weights)
    model = model.to(device)

    joint_input = np.load(pose_path).reshape(17, -1).astype(np.float32)
    if joint_set == "coco":
        if joint_input.shape[1] == 2:
            joint_input = np.concatenate(
                [joint_input, np.ones((17, 1), np.float32)], axis=1)
        joint_input = add_pelvis_neck_3(
            joint_input, list(assets.joint_set.joints_name))[:, :2]
    else:
        joint_input = joint_input[:, :2]

    # two crops: the square 500 one for the projection target, the model
    # input crop (reference: run.py:123-145)
    bbox = coords.get_bbox(joint_input)
    bbox1 = coords.process_bbox(bbox.copy(), 1.0, scale=1.25)
    bbox2 = coords.process_bbox(bbox.copy(), 288.0 / 384.0)
    scored = np.concatenate(
        [joint_input, np.ones((len(joint_input), 1), np.float32)], 1)
    proj_target, _ = augment.j2d_processing(
        scored, (VIRTUAL_CROP, VIRTUAL_CROP), bbox1, 0, 0, None)
    model_in, _ = augment.j2d_processing(scored, (288, 384), bbox2, 0, 0,
                                         None)
    pose2d = augment.normalize_input_pose(model_in[:, :2], (384, 288))

    with torch.no_grad():
        mesh, _ = model(torch.from_numpy(pose2d[None]).to(device))
    pred_mesh = mesh[0].cpu().numpy()                 # [V, 3] metres
    j_reg = (assets.j_regressor_coco if joint_set == "coco"
             else assets.j_regressor_h36m)
    pred_joints = torch.as_tensor(j_reg, device=device) @ mesh[0]

    target = torch.from_numpy(proj_target[None, :17, :2]).to(device)
    if adam_fit:
        cam, loss = fit_camera_adam(pred_joints[None], target, VIRTUAL_CROP)
    else:
        cam = fit_camera_closed_form(pred_joints[None], target,
                                     VIRTUAL_CROP)
        loss = (project_weak_perspective(pred_joints[None], cam,
                                         VIRTUAL_CROP) - target).abs().mean()
    print(f"camera fit: s={float(cam.s[0, 0]):.3f} "
          f"t=({float(cam.t[0, 0]):.3f}, {float(cam.t[0, 1]):.3f}) "
          f"L1={float(loss):.2f}px")

    obj_path = osp.join(output_dir, "demo_mesh.obj")
    save_obj(pred_mesh, assets.faces, obj_path)

    try:
        import cv2
    except ImportError as err:
        print(f"skipped {' and '.join(IMAGES)}: cv2 is not installed "
              f"({err})")
    else:
        if input_img:
            orig_img = cv2.imread(input_img)
            oh, ow = orig_img.shape[:2]
        else:
            ow = int(joint_input[:, 0].max() * 1.5)
            oh = int(joint_input[:, 1].max() * 1.5)
            orig_img = np.zeros((oh, ow, 3), np.uint8)
        orig_cam = crop_cam_to_orig_img(
            cam, torch.from_numpy(bbox1[None]).to(device), ow, oh)[0]
        mesh_img = render_mesh_overlay(orig_img, pred_mesh, assets.faces,
                                       orig_cam.cpu().numpy())
        cv2.imwrite(osp.join(output_dir, IMAGES[0]), mesh_img)
        kps = np.zeros((3, len(joint_input)), np.float32)
        kps[0], kps[1], kps[2] = joint_input[:, 0], joint_input[:, 1], 1
        pose_img = vis_2d_keypoints(orig_img.copy(), kps,
                                    assets.joint_set.skeleton)
        cv2.imwrite(osp.join(output_dir, IMAGES[1]), pose_img)
    print(f"results saved in {output_dir}")
    return {"mesh": pred_mesh, "cam": cam, "obj_path": obj_path}


def main(argv=None):
    args = parse_args(argv)
    return run_demo(args.input_pose, args.joint_set, args.weights,
                    args.output_dir, args.input_img, args.adam_fit,
                    device=args.device)


if __name__ == "__main__":
    main()
