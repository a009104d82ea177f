"""Evaluation CLI on one device (counterpart of gator_tpu/cli/test.py;
reference: main/test.py:1-33):

    python -m gator_tpu_torch.cli.test --cfg configs/gator_synthetic_e2e.yml \
        --synthetic [--weights ckpt.pth.tar] [--device cpu]

Builds the config's model (GATOR or the GAT lifter alone), loads --weights
(a `.pth.tar` in the reference's layout, a bare state dict, or a directory
of checkpoints: `train.checkpoint.load_weights`), runs the eval loop with
exact per-sample aggregation and prints MPVPE and MPJPE in mm. The GATOR
eval runs the module form, whose MDR vertex self-attention is the K3
kernel on the card. The default device is cuda; there is no fallback to
the CPU.

`cfg.TEST.vis` dumps every 10th predicted GATOR mesh as .obj. The JAX CLI
dumps only inside the real datasets' metric suite, which the port does not
have yet; the port dumps whenever its predictions are in dataset row order.
--debug subsamples the real Human36M test split in the JAX package and has
no effect on the synthetic data, the only data the port reads yet.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Any, Dict, Tuple

from ..config import Config, load_config
from ..train import load_weights, run_eval
from ..vis import save_obj
from .common import Session


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate GATOR/GAT (PyTorch)")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--weights", type=str, default=None,
                   help="checkpoint (.pth.tar) or a directory of them "
                        "(default: cfg.TEST.weight_path)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--vis_dir", type=str, default="./vis_out",
                   help="output dir for cfg.TEST.vis mesh dumps")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def run_test(cfg: Config, weights: str | None = None,
             synthetic: bool = False, vis_dir: str = "./vis_out",
             device: str = "cuda", assets=None, synthetic_n: int = 256
             ) -> Tuple[Dict, Dict[str, Any]]:
    """-> (what the CLI returns, run_eval's result: exact mean errors,
    count and the gathered predictions and targets). `assets` and
    `synthetic_n` are as in `Session`."""
    sess = Session(cfg, synthetic=synthetic, assets=assets,
                   synthetic_n=synthetic_n, device=device)
    model = sess.build_model()
    weight_path = weights or cfg.TEST.weight_path
    if weight_path:
        load_weights(model, weight_path)
        print(f"loaded weights from {weight_path}")
    else:
        print("WARNING: evaluating randomly initialized weights")

    eval_step = sess.make_eval_step()
    if sess.is_gator:
        res = run_eval(eval_step, model, sess.pipeline,
                       collect_out=("pred_mesh_mm",),
                       collect_batch=("mesh",))
        print(f"MPVPE: {res['surface_err']:.2f}, "
              f"MPJPE: {res['joint_err']:.2f}")
    else:
        res = run_eval(eval_step, model, sess.pipeline,
                       collect_out=("pred_pose_mm",),
                       collect_batch=("joint_cam",))
        print(f"MPJPE: {res['joint_err']:.2f}")

    out = {"mpjpe": float(res["joint_err"])}
    if cfg.TEST.shuffle or len(sess.datasets) > 1:
        print("skipping the dataset metric suite: predictions are not in "
              "dataset row order (TEST.shuffle or a multi-dataset test "
              "list); the aggregate errors above are exact")
        return out, res
    if sess.is_gator and cfg.TEST.vis:
        pred = res["pred_mesh_mm"][:len(sess.datasets[0])]
        os.makedirs(vis_dir, exist_ok=True)
        for n in range(0, len(pred), 10):
            save_obj(pred[n] / 1000.0, sess.assets.faces,
                     osp.join(vis_dir, f"eval_{n:06d}.obj"))
        print(f"dumped {len(range(0, len(pred), 10))} meshes to {vis_dir}")
    return out, res


def main(argv=None):
    a = parse_args(argv)
    return run_test(load_config(a.cfg), a.weights, a.synthetic, a.vis_dir,
                    a.device)[0]


if __name__ == "__main__":
    main()
