"""Evaluation CLI on one card or sharded over several (counterpart of
gator_tpu/cli/test.py; reference: main/test.py:1-33):

    python -m gator_tpu_torch.cli.test --cfg configs/gator_synthetic_e2e.yml \
        --synthetic [--weights ckpt.pth.tar] [--device cpu]

Builds the config's model (GATOR or the GAT lifter alone), loads --weights
(a `.pth.tar` in the reference's layout, a bare state dict, or a directory
of checkpoints: `train.checkpoint.load_weights`; a `gator_tpu` orbax
checkpoint goes through `tools/jax_checkpoint_to_torch.py` first; without
--weights, the config's TEST.weight_path, which must exist; random weights
from the config's seed only where both are empty), runs the
eval loop with exact per-sample aggregation and prints MPVPE and MPJPE in
mm. Then, for a single unshuffled test dataset with a metric suite
(Human36M, PW3D), its `evaluate` (`evaluate_joint` for the GAT lifter) on
the session's device, and the `cfg.TEST.vis` dump of every 10th predicted
mesh as .obj (reference: data/PW3D/dataset.py:377-381). The datasets are
read from $GATOR_DATA_DIR (or ./data), or are synthetic with --synthetic;
--debug keeps the first Human36M subject. The GATOR eval runs the module
form, whose MDR vertex self-attention is the K3 kernel on the card. The
default device is cuda; there is no fallback to the CPU.

On N cards, one process each: `torchrun --standalone --nproc_per_node=N
-m gator_tpu_torch.cli.test ...`. The eval loop is sharded
(`run_eval(world=)`: exact means on any world size), and rank 0 alone runs
the dataset's metric suite on the gathered, row-ordered predictions and
prints it.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Any, Dict, Tuple

import torch

from ..config import Config, load_config
from ..parallel import launched, main_print
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
             device: str = "cuda", assets=None, synthetic_n: int = 256,
             debug: bool = False, world=None) -> Tuple[Dict, Dict[str, Any]]:
    """-> (what the CLI returns: the dataset's metric suite, or the mean
    MPJPE where there is none; run_eval's result: exact mean errors, count
    and the gathered predictions and targets). `assets` and `synthetic_n`
    are as in `Session`. `world`: the data-parallel ranks the eval loop is
    sharded over; ranks other than 0 return the mean MPJPE in place of the
    suite."""
    say = main_print(world)
    sess = Session(cfg, synthetic=synthetic, assets=assets,
                   synthetic_n=synthetic_n, device=device, debug=debug,
                   world=world)
    model = sess.build_model()
    weight_path = weights or cfg.TEST.weight_path
    if weight_path:
        load_weights(model, weight_path)
        say(f"loaded weights from {weight_path}")
    else:
        say("WARNING: evaluating randomly initialized weights")

    eval_step = sess.make_eval_step()
    if sess.is_gator:
        res = run_eval(eval_step, model, sess.pipeline,
                       collect_out=("pred_mesh_mm",),
                       collect_batch=("mesh",), world=world)
        say(f"MPVPE: {res['surface_err']:.2f}, "
            f"MPJPE: {res['joint_err']:.2f}")
    else:
        res = run_eval(eval_step, model, sess.pipeline,
                       collect_out=("pred_pose_mm",),
                       collect_batch=("joint_cam",), world=world)
        say(f"MPJPE: {res['joint_err']:.2f}")

    # the dataset's metric suite indexes its table by row, so it needs the
    # predictions in row order: one unshuffled test dataset (the reference
    # tester always iterates in order)
    out = {"mpjpe": float(res["joint_err"])}
    ds = sess.datasets[0]
    if world is not None and not world.is_main:
        return out, res
    if cfg.TEST.shuffle or len(sess.datasets) > 1:
        print("skipping the dataset metric suite: predictions are not in "
              "dataset row order (TEST.shuffle or a multi-dataset test "
              "list); the aggregate errors above are exact")
        return out, res

    def on_device(x):
        return torch.as_tensor(x[:len(ds)], device=sess.device)

    if sess.is_gator and hasattr(ds, "evaluate"):
        pred = res["pred_mesh_mm"][:len(ds)]
        if cfg.TEST.vis:
            os.makedirs(vis_dir, exist_ok=True)
            for n in range(0, len(pred), 10):
                save_obj(pred[n] / 1000.0, sess.assets.faces,
                         osp.join(vis_dir, f"eval_{n:06d}.obj"))
            print(f"dumped {len(range(0, len(pred), 10))} meshes "
                  f"to {vis_dir}")
        out = ds.evaluate(on_device(pred), on_device(res["mesh"]) * 1000.0)
    elif not sess.is_gator and hasattr(ds, "evaluate_joint"):
        out = ds.evaluate_joint(on_device(res["pred_pose_mm"]),
                                on_device(res["joint_cam"]))
    return out, res


def main(argv=None):
    """The CLI; under torchrun, one rank of a data-parallel run."""
    a = parse_args(argv)
    with launched(a.device) as world:
        return run_test(load_config(a.cfg), a.weights, a.synthetic,
                        a.vis_dir, a.device, debug=a.debug, world=world)[0]


if __name__ == "__main__":
    main()
