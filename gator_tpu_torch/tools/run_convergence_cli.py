"""Multi-epoch convergence artifact of the port (counterpart of
tools/run_convergence_cli.py, which drives the JAX CLI): run the port's
whole training CLI (`cli.train.run_train`: checkpoints, the plateau
scheduler stepping on eval MPJPE, the edge-loss gate opening mid-run,
best-model tracking, per-epoch eval) for N synthetic epochs on the card,
check that the eval error improves, and record the curves (reference
loop: main/train.py:37-62).

    python -m gator_tpu_torch.tools.run_convergence_cli [--epochs 12] \
        [--n 2048] [--out artifacts/convergence_torch.json]

Two stages (reference main/train.py:31-33: GAT lifter pretrain, then
GATOR loads it through MODEL.posenet_pretrained/path,
lib/models/GAT.py:125-131), compared with a scratch run's artifact:

    python -m gator_tpu_torch.tools.run_convergence_cli --two_stage \
        --stage1_cfg configs/gat_cocoJ_synthetic_convergence.yml \
        --cfg configs/gator_synthetic_flagship.yml \
        --baseline <scratch artifact> \
        --out artifacts/convergence_two_stage_torch.json

`--set SECTION.key=value` derives a temporary config from --cfg;
`--recheck <artifact>` runs the checks again on an existing artifact. The
artifact has the JAX tool's keys, `device` the card's name, `card` its
name and power limit (nvidia-smi), and per epoch the samples/s and the
train, eval and checkpoint-save wall seconds. `--seed` sets cfg.seed for
every run (0, as the JAX tool runs). `--device cpu` runs on the CPU (a
run there is no measurement of the card).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _parse_val(s: str):
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def derived_cfg(base_path: str, updates: dict) -> str:
    """Write a temporary YAML: the base config with dotted-path updates
    ({"MODEL.posenet_path": ...}) -> its path. The derived file is what
    the run loads, so the artifact records what ran."""
    import yaml
    with open(base_path) as f:
        raw = yaml.safe_load(f) or {}
    for dotted, val in updates.items():
        section, key = dotted.split(".", 1)
        raw.setdefault(section, {})[key] = val
    fd, path = tempfile.mkstemp(suffix=".yml", prefix="gator_cfg_")
    with os.fdopen(fd, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _card(device: str):
    """-> (the device's name, nvidia-smi's name and power limit or None)."""
    import torch
    if not device.startswith("cuda"):
        return "cpu", None
    from .timing import card_name
    return torch.cuda.get_device_name(0), card_name()


def run(epochs: int, n: int, exp_dir: str, cfg_path: str, seed: int = 0,
        device: str = "cuda"):
    from ..cli.train import run_train
    from ..config import load_config
    from ..train import load_checkpoint, pick_checkpoint

    log: list = []
    t0 = time.time()
    best = run_train(load_config(cfg_path, {"seed": seed}), exp_dir=exp_dir,
                     synthetic=True, synthetic_n=n, epochs=epochs,
                     device=device, epoch_log=log)
    wall = time.time() - t0
    ckpt = load_checkpoint(pick_checkpoint(
        os.path.join(exp_dir, "checkpoint")))
    test_log = ckpt.get("test_log") or {}
    name, card = _card(device)
    return {
        "config": cfg_path,
        "epochs": epochs,
        "synthetic_n": n,
        "seed": seed,
        "wall_seconds": round(wall, 1),
        "device": name,
        "card": card,
        "best_joint_err_mm": float(best),
        "train_loss_per_epoch": [round(float(x), 5)
                                 for x in ckpt.get("train_log", [])],
        "eval_mpjpe_per_epoch": [round(float(x), 3)
                                 for x in test_log.get("joint", [])],
        "eval_mpvpe_per_epoch": [round(float(x), 3)
                                 for x in test_log.get("surface", [])],
        "plateau_scheduler_state": {
            k: float(v) for k, v in
            (ckpt.get("scheduler_state_dict") or {}).items()},
        "best_dir_exists": os.path.isfile(
            os.path.join(exp_dir, "checkpoint", "best.pth.tar")),
        "samples_per_s_per_epoch": [e["samples_per_s"] for e in log],
        "epoch_seconds": [{k: e[k] for k in ("train_s", "eval_s", "save_s")}
                          for e in log],
    }


def check(result: dict, edge_loss_start: int = 0) -> list:
    """Convergence assertions -> a list of failures (empty: passed).

    The train-loss check segments at the edge-loss gate: from epoch
    edge_loss_start+1 the loss gains a weight-20 edge term (reference:
    main/train.py loss schedule), so its scale jumps mid-run and a first
    against last comparison means nothing across the gate. The loss must
    decrease within each regime; eval MPJPE (whose meaning never changes)
    carries the improvement across the run."""
    fails = []
    j = result["eval_mpjpe_per_epoch"]
    ls = result["train_loss_per_epoch"]
    if len(j) < result["epochs"]:
        fails.append(f"missing eval epochs: {len(j)}")
    if j and not (min(j) < 0.7 * j[0]):
        fails.append(f"eval MPJPE did not improve >=30%: {j[0]} -> "
                     f"{min(j)}")
    if j and not (j[-1] <= 1.25 * min(j)):
        fails.append(f"eval MPJPE diverged at the end: last {j[-1]} vs "
                     f"best {min(j)}")
    # epochs 1..edge_loss_start are before the gate (index 0..gate-1); it
    # opens at epoch edge_loss_start+1 (index edge_loss_start)
    gate = min(max(edge_loss_start, 0), len(ls))
    for seg, lo, hi in (("pre-gate", 0, gate), ("post-gate", gate,
                                                len(ls))):
        if hi - lo >= 2 and not (ls[hi - 1] < ls[lo]):
            fails.append(f"{seg} train loss did not decrease: "
                         f"{ls[lo]} -> {ls[hi - 1]}")
    if not result["best_dir_exists"]:
        fails.append("best/ checkpoint missing")
    return fails


def _edge_loss_start(cfg_path: str) -> int:
    import yaml
    with open(cfg_path) as f:
        y = yaml.safe_load(f) or {}
    return int((y.get("TRAIN") or {}).get("edge_loss_start", 0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--cfg", type=str,
                    default="configs/gator_synthetic_convergence.yml")
    ap.add_argument("--exp_dir", type=str, default=None)
    ap.add_argument("--out", type=str,
                    default="artifacts/convergence_torch.json")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    metavar="SECTION.key=value",
                    help="override config fields (repeatable)")
    ap.add_argument("--two_stage", action="store_true",
                    help="pretrain the GAT lifter (--stage1_cfg), then "
                         "train --cfg with posenet_pretrained pointing at "
                         "the stage-1 best checkpoint")
    ap.add_argument("--stage1_cfg", type=str,
                    default="configs/gat_synthetic_convergence.yml")
    ap.add_argument("--stage1_epochs", type=int, default=8)
    ap.add_argument("--baseline", type=str, default=None,
                    help="existing single-stage artifact to compare "
                         "best_joint_err_mm against (two-stage mode)")
    ap.add_argument("--recheck", type=str, default=None,
                    help="re-run the assertions on an existing artifact "
                         "(no training) and rewrite its passed/failures")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="cfg.seed of every run (weights, data, dropout)")
    args = ap.parse_args(argv)

    if args.recheck:
        with open(args.recheck) as f:
            result = json.load(f)
        fails = check(result, _edge_loss_start(result["config"]))
        result["passed"] = not fails
        result["failures"] = fails
        with open(args.recheck, "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps({"passed": result["passed"],
                          "failures": fails}, indent=1))
        return 1 if fails else 0

    exp_dir = args.exp_dir or tempfile.mkdtemp(prefix="gator_convergence_")
    updates = dict(kv.split("=", 1) for kv in args.sets)
    updates = {k: _parse_val(v) for k, v in updates.items()}

    stage1 = None
    if args.two_stage:
        s1_dir = os.path.join(exp_dir, "stage1")
        stage1 = run(args.stage1_epochs, args.n, s1_dir, args.stage1_cfg,
                     seed=args.seed, device=args.device)
        stage1["stage"] = "gat_pretrain"
        updates["MODEL.posenet_pretrained"] = True
        updates["MODEL.posenet_path"] = os.path.join(s1_dir, "checkpoint")

    cfg_path = derived_cfg(args.cfg, updates) if updates else args.cfg
    s2_dir = os.path.join(exp_dir, "stage2") if args.two_stage else exp_dir
    result = run(args.epochs, args.n, s2_dir, cfg_path, seed=args.seed,
                 device=args.device)
    result["config"] = args.cfg
    if updates:
        result["overrides"] = dict(updates)
    fails = check(result, _edge_loss_start(cfg_path))
    if stage1 is not None:
        result["stage1"] = stage1
        # the two-stage claim: the pretrained init beats the scratch run
        if args.baseline and os.path.exists(args.baseline):
            with open(args.baseline) as f:
                base = json.load(f)
            result["scratch_best_joint_err_mm"] = base["best_joint_err_mm"]
            result["beats_scratch"] = (result["best_joint_err_mm"]
                                       < base["best_joint_err_mm"])
            if not result["beats_scratch"]:
                fails.append(
                    f"two-stage best {result['best_joint_err_mm']:.1f} mm "
                    f"did not beat scratch "
                    f"{base['best_joint_err_mm']:.1f} mm")
    result["passed"] = not fails
    result["failures"] = fails
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("train_loss_per_epoch", "stage1")},
                     indent=1))
    print(f"-> {args.out}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
