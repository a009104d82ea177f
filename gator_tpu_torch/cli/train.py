"""Training CLI on one card or data-parallel over several (counterpart of
gator_tpu/cli/train.py; reference: main/train.py:1-62):

    python -m gator_tpu_torch.cli.train \
        --cfg configs/gator_synthetic_smoke.yml --synthetic [--epochs N] \
        [--exp_dir DIR] [--resume_training] [--device cpu]

Per epoch: the config's train step on K4/K5 (stage 2, GATOR) or K5 (stage
1, the GAT lifter) over the training session's pipeline, in whichever
TRAIN.gt_in_step mode the session resolves; the eval loop on the eval
session's pipeline (the GATOR's MDR self-attention on K3); the plateau
controller stepped on the eval MPJPE; checkpoint{N}.pth.tar (final.pth.tar
for the last epoch, best.pth.tar on a new best joint error) under
<exp_dir>/checkpoint; the loss plot <exp_dir>/train_loss.pdf. A stage-2
config with MODEL.posenet_pretrained loads its lifter from the stage-1 run
under MODEL.posenet_path (best first; reference: lib/models/GAT.py:125-131).
--resume_training continues from the newest checkpoint of <exp_dir>:
weights, BatchNorm stats, optimizer state, step, plateau state and
histories. On SIGTERM the step in flight finishes, the state the epoch
began with is written as checkpoint{epoch-1} and the run returns, so that
--resume_training repeats that epoch as an uninterrupted run takes it.
The default device is cuda; there is no fallback to the CPU.

On N cards, one process each:

    torchrun --standalone --nproc_per_node=N -m gator_tpu_torch.cli.train \
        --cfg configs/gator_synthetic_smoke.yml --synthetic

TRAIN.batch_size is the global batch; each rank trains on its rows of it
and the step computes what one device computes on the whole batch
(`train.loop`). Rank 0 alone writes the checkpoints, the loss plot and
wandb, and prints; every rank resumes from the same checkpoint. The eval
loop is sharded, so every rank (and its plateau controller) sees the same
exact error. The SIGTERM flag is all-reduced (max) after every step, so
every rank stops after the same step and rank 0 writes one checkpoint.
"""
from __future__ import annotations

import argparse
import copy
import os
import os.path as osp
import signal
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config, load_config
from ..parallel import any_rank, broadcast_object, launched, main_print
from ..train import (load_checkpoint, load_weights, pick_checkpoint,
                     run_eval, save_checkpoint, set_learning_rate)
from ..vis import save_loss_plot
from .common import Session


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train GAT / GATOR (PyTorch)")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--resume_training", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic dataset (no downloads)")
    p.add_argument("--synthetic_n", type=int, default=256,
                   help="synthetic dataset size (with --synthetic)")
    p.add_argument("--exp_dir", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None,
                   help="override cfg.TRAIN.end_epoch")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _host(m: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """A step's metrics on the host with one sync for the whole dict."""
    vals = torch.stack([v.detach().float() for v in m.values()]).tolist()
    return dict(zip(m, vals))


def run_train(cfg: Config, exp_dir: Optional[str] = None,
              synthetic: bool = False, synthetic_n: int = 256,
              epochs: Optional[int] = None, resume: bool = False,
              debug: bool = False, device: str = "cuda", assets=None,
              epoch_log: Optional[List[dict]] = None, world=None) -> float:
    """Train as `main` does -> the best eval joint error (mm). `assets`
    is as in `Session`; `epoch_log`, where given, gets one dict per epoch
    (loss, errors, steps, samples/s, and the train, eval and save wall
    seconds). `world`: the data-parallel ranks (module docstring); None
    is one device."""
    main_rank = world is None or world.is_main
    say = main_print(world)
    # rank 0's default name on every rank (the clocks may differ)
    exp_dir = broadcast_object(exp_dir or osp.join(
        "experiment", f"exp_{time.strftime('%m-%d_%H%M%S')}"), world)
    ckpt_dir = osp.join(exp_dir, "checkpoint")
    os.makedirs(ckpt_dir, exist_ok=True)
    say(f"experiment dir: {exp_dir}")

    sess = Session(cfg, synthetic=synthetic, assets=assets,
                   synthetic_n=synthetic_n, device=device, debug=debug,
                   is_train=True, world=world)
    eval_sess = Session(cfg, synthetic=synthetic, assets=sess.assets,
                        device=device, debug=debug, world=world)

    # optional experiment tracking (reference: lib/core/base.py:114-120;
    # gated by cfg.TRAIN.wandb and an import that succeeds), on rank 0
    wandb_run = None
    if cfg.TRAIN.wandb and main_rank:
        try:
            import wandb
            wandb_run = wandb.init(project=cfg.MODEL.name,
                                   name=f"GATOR/{exp_dir}", dir=exp_dir,
                                   job_type="training", reinit=True)
        except Exception as exc:   # wandb not installed / offline
            print(f"wandb disabled ({exc})")

    state, step = sess.make_train_step(sess.make_optimizer())
    eval_step = eval_sess.make_eval_step()

    # stage-2 init from a pretrained stage-1 lifter (reference:
    # GAT.py:125-131 via cfg.MODEL.posenet_pretrained/path): the GAT's own
    # keys, strictly, into model.pose_lifter
    if sess.is_gator and cfg.MODEL.posenet_pretrained \
            and cfg.MODEL.posenet_path:
        load_weights(state.model.pose_lifter, cfg.MODEL.posenet_path)
        say(f"loaded pretrained lifter from {cfg.MODEL.posenet_path}")

    begin_epoch = cfg.TRAIN.begin_epoch
    loss_history: List[float] = []
    error_history: Dict[str, List[float]] = {"surface": [], "joint": []}
    if resume:
        restored = load_checkpoint(pick_checkpoint(ckpt_dir),
                                   target_state=state)
        begin_epoch = int(restored["epoch"]) + 1
        loss_history = [float(x) for x in restored.get("train_log") or []]
        th = restored.get("test_log") or {}
        error_history = {k: [float(x) for x in th.get(k, [])]
                         for k in ("surface", "joint")}
        if sess.plateau is not None and restored.get("scheduler_state_dict"):
            sess.plateau.load_state_dict(restored["scheduler_state_dict"])
        say(f"resumed from epoch {begin_epoch - 1} (step {state.step})")
    say(f"device: {sess.device}; input mode {sess.gt_in_step}"
        + (f"; {world.size} ranks" if world is not None and world.size > 1
           else ""))
    if cfg.TRAIN.steps_per_dispatch > 1:
        say(f"TRAIN.steps_per_dispatch={cfg.TRAIN.steps_per_dispatch} "
              "ignored: the port takes one step per dispatch")

    # preemption: finish the step in flight, write a resumable checkpoint,
    # return (the handler is the caller's again when this returns); a
    # data-parallel run stops when any rank has the flag
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True
        print("SIGTERM received: checkpointing at the end of this step"
              + (f" (rank {world.rank})" if world is not None
                 and world.size > 1 else ""))

    def plateau_state():
        return sess.plateau.state_dict() if sess.plateau is not None \
            else None

    end_epoch = epochs if epochs is not None else cfg.TRAIN.end_epoch
    # on resume, the restored history sets the bar a new epoch must beat
    best_joint_err = (float(min(error_history["joint"]))
                      if error_history["joint"] else np.inf)
    plot_said = False
    previous = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        for epoch in range(begin_epoch, end_epoch + 1):
            sess.pipeline.set_epoch(epoch)
            edge_on = 1.0 if (sess.is_gator
                              and epoch > cfg.TRAIN.edge_loss_start) else 0.0
            extra = (cfg.seed, edge_on) if sess.is_gator else (cfg.seed,)
            # the state this epoch begins with, on the device: what
            # SIGTERM writes as checkpoint{epoch-1}
            begun = (copy.deepcopy(state.model.state_dict()),
                     copy.deepcopy(state.optimizer.state_dict()), state.step)
            # the epoch loss is one f32 device scalar: a host read per
            # step would wait for the card every step
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=sess.device)
            steps, last_print, t0 = 0, 0, time.time()
            for batch in sess.pipeline:
                m = step(state, batch, *extra)
                loss_sum = loss_sum + m["loss"]
                steps += 1
                if any_rank(preempted["flag"], world):
                    state.model.load_state_dict(begun[0])
                    state.optimizer.load_state_dict(begun[1])
                    state.step = begun[2]
                    save_checkpoint(ckpt_dir, state.model, epoch - 1,
                                    state.optimizer, loss_history,
                                    error_history,
                                    scheduler_state=plateau_state(),
                                    step=state.step, world=world)
                    say(f"preempted at epoch {epoch} step {steps}; "
                        f"checkpoint{epoch - 1} written, resume with "
                        f"--resume_training")
                    if not main_rank:
                        print(f"rank {world.rank}: preempted at epoch "
                              f"{epoch} step {steps}")
                    return best_joint_err
                if wandb_run is not None:
                    wandb_run.log({f"train_loss/{k}": v
                                   for k, v in _host(m).items()})
                if main_rank and steps - last_print >= cfg.TRAIN.print_freq:
                    last_print = steps
                    msg = " ".join(f"{k}: {v:.4f}"
                                   for k, v in _host(m).items())
                    print(f"epoch {epoch} [{steps}/{len(sess.pipeline)}] "
                          f"{msg}")
            epoch_loss = float(loss_sum) / steps if steps else 0.0
            loss_history.append(epoch_loss)
            dt = time.time() - t0
            sps = steps * cfg.TRAIN.batch_size / max(dt, 1e-9)
            say(f"epoch {epoch} loss {epoch_loss:.4f} "
                f"({dt:.1f}s, {sps:.0f} samples/s)")

            # eval with exact per-sample aggregation (reference runs the
            # tester every epoch: main/train.py:41, base.py:224-230)
            t1 = time.time()
            res = run_eval(eval_step, state.model, eval_sess.pipeline,
                           world=world)
            j_err = float(res.get("joint_err", np.inf))
            s_err = float(res.get("surface_err", np.inf))
            error_history["joint"].append(j_err)
            error_history["surface"].append(s_err)
            say(f"epoch {epoch} MPJPE: {j_err:.2f}  MPVPE: {s_err:.2f}")
            if wandb_run is not None:
                wandb_run.log({"error/MPJPE": j_err, "error/MPVPE": s_err})

            # the plateau scheduler steps on the eval metric (reference:
            # lib/funcs_utils.py:106-107 via cfg.TRAIN.scheduler)
            if sess.plateau is not None:
                new_lr = sess.plateau.update(j_err)
                set_learning_rate(state, new_lr)
                say(f"plateau lr: {new_lr:g}")

            t2 = time.time()
            is_best = j_err < best_joint_err
            best_joint_err = min(best_joint_err, j_err)
            save_checkpoint(ckpt_dir, state.model, epoch, state.optimizer,
                            loss_history, error_history, is_best=is_best,
                            is_final=(epoch == end_epoch),
                            scheduler_state=plateau_state(),
                            step=state.step, world=world)
            if main_rank and not save_loss_plot(
                    loss_history, osp.join(exp_dir, "train_loss.pdf")) \
                    and not plot_said:
                plot_said = True
                print("matplotlib is not installed: train_loss.pdf skipped "
                      "(the loss history is each checkpoint's train_log)")
            if epoch_log is not None:
                epoch_log.append({
                    "epoch": epoch, "loss": epoch_loss, "joint_err": j_err,
                    "surface_err": s_err, "steps": steps,
                    "samples_per_s": sps, "train_s": dt, "eval_s": t2 - t1,
                    "save_s": time.time() - t2})
    finally:
        signal.signal(signal.SIGTERM, previous)
    say(f"done; best joint error {best_joint_err:.2f}")
    return best_joint_err


def main(argv=None):
    """The CLI; under torchrun, one rank of a data-parallel run."""
    a = parse_args(argv)
    cfg = load_config(a.cfg, {"seed": a.seed} if a.seed is not None
                      else None)
    with launched(a.device) as world:
        return run_train(cfg, exp_dir=a.exp_dir, synthetic=a.synthetic,
                         synthetic_n=a.synthetic_n, epochs=a.epochs,
                         resume=a.resume_training, debug=a.debug,
                         device=a.device, world=world)


if __name__ == "__main__":
    main()
