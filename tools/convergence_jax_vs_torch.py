"""The JAX package's training CLI and the port's on the CPU, one recipe at
a reduced size, over a convergence-length run: the same flax init (the
port loads it through `state_dict_from_jax`), the same synthetic data,
dropout on at the config's rates in both (each package draws its own
masks), f32. Prints both per-epoch curves and both convergence tools'
checks, and writes them to --out.

    python tools/convergence_jax_vs_torch.py \
        [--cfg configs/gator_synthetic_convergence.yml] [--epochs 12] \
        [--n 256] [--batch 32] [--depth 2] [--vertices 890] \
        [--out build/convergence_jax_vs_torch.json]

The size is cut so that both run here (~2 min): the config's depth, the
SMPL mesh (synthetic assets of --vertices vertices), the dataset and the
batch; the train batch keeps the recipe's steps an epoch at the defaults
(2048 / 256 = 256 / 32 = 8). `gator_tpu.cli.train.main` runs whole, with
its assets, its init and its mesh (the first CPU device) patched in;
`gator_tpu_torch.cli.train.run_train` runs whole on the CPU. Needs JAX,
so it lives outside both packages.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import tempfile
from unittest import mock

import yaml

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)


def _config(path: str, out_dir: str, depth: int, batch: int) -> str:
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"]["depth"] = depth
    raw["TRAIN"].update({"batch_size": batch, "precision": "float32",
                         "steps_per_dispatch": 1, "print_freq": 1000})
    raw["TEST"]["batch_size"] = 64
    out = osp.join(out_dir, "cfg.yml")
    with open(out, "w") as f:
        yaml.safe_dump(raw, f)
    return out


def run_jax(cfg_path: str, exp_dir: str, args):
    """gator_tpu.cli.train.main on small assets and one CPU device ->
    (the flax init, its curves)."""
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=1")
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from gator_tpu import assets as jassets
    from gator_tpu.cli import common as jcommon
    from gator_tpu.cli import train as jtrain
    from gator_tpu.models import init_gat, init_gator
    from gator_tpu.parallel import make_mesh
    from gator_tpu.train import load_checkpoint

    assets = jassets.build_assets("human36", data_dirs=[],
                                  synthetic_vertex_num=args.vertices,
                                  seed=0)
    seen = {}

    def init_variables(self, rng=None):
        fn = init_gator if self.is_gator else init_gat
        key = jax.random.PRNGKey(self.cfg.seed)
        init = jax.jit(lambda k: fn(self.spec, k)).lower(key).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        seen["variables"] = jax.tree_util.tree_map(np.asarray, init(key))
        return jax.tree_util.tree_map(jnp.asarray, seen["variables"])

    with mock.patch.object(jcommon, "build_assets",
                           lambda *a, **k: assets), \
            mock.patch.object(jcommon.Session, "init_variables",
                              init_variables), \
            mock.patch.object(jtrain, "make_mesh",
                              lambda: make_mesh(jax.devices()[:1])):
        jtrain.main(["--cfg", cfg_path, "--synthetic", "--synthetic_n",
                     str(args.n), "--epochs", str(args.epochs),
                     "--exp_dir", exp_dir])
    ckpt = load_checkpoint(osp.join(exp_dir, "checkpoint", "final"))
    return seen["variables"], {
        "train_loss_per_epoch": [float(x) for x in ckpt["train_log"]],
        "eval_mpjpe_per_epoch": [float(x)
                                 for x in ckpt["test_log"]["joint"]],
        "eval_mpvpe_per_epoch": [float(x)
                                 for x in ckpt["test_log"]["surface"]]}


def run_port(cfg_path: str, exp_dir: str, variables, args) -> dict:
    import torch

    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.cli import common
    from gator_tpu_torch.cli.train import run_train
    from gator_tpu_torch.config import load_config
    from gator_tpu_torch.convert import state_dict_from_jax
    from gator_tpu_torch.train import load_checkpoint

    assets = build_assets("human36", data_dirs=[],
                          synthetic_vertex_num=args.vertices, seed=0)
    build = common.Session.build_model

    def build_model(self):
        model = build(self)
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
        return model

    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    with mock.patch.object(common.Session, "build_model", build_model):
        run_train(load_config(cfg_path), exp_dir=exp_dir, synthetic=True,
                  synthetic_n=args.n, epochs=args.epochs, device="cpu",
                  assets=assets)
    ckpt = load_checkpoint(osp.join(exp_dir, "checkpoint", "final.pth.tar"))
    return {"train_loss_per_epoch": ckpt["train_log"],
            "eval_mpjpe_per_epoch": ckpt["test_log"]["joint"],
            "eval_mpvpe_per_epoch": ckpt["test_log"]["surface"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", default="configs/gator_synthetic_convergence.yml")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--vertices", type=int, default=890)
    ap.add_argument("--out", default="build/convergence_jax_vs_torch.json")
    args = ap.parse_args(argv)

    from gator_tpu_torch.tools.run_convergence_cli import (_edge_loss_start,
                                                           check)

    with tempfile.TemporaryDirectory() as tmp:
        # the JAX Session's persistent compile cache, here and nowhere else
        os.environ["JAX_CACHE_DIR"] = osp.join(tmp, "jax_cache")
        cfg_path = _config(args.cfg, tmp, args.depth, args.batch)
        variables, jax_curves = run_jax(cfg_path, osp.join(tmp, "jax"), args)
        port_curves = run_port(cfg_path, osp.join(tmp, "port"), variables,
                               args)
        gate = _edge_loss_start(cfg_path)
    out = {"config": args.cfg, "epochs": args.epochs, "synthetic_n": args.n,
           "batch_size": args.batch, "depth": args.depth,
           "vertices": args.vertices, "device": "cpu", "precision": "float32"}
    for name, curves in (("jax", jax_curves), ("torch", port_curves)):
        result = dict(curves, epochs=args.epochs, best_dir_exists=True)
        out[name] = dict(curves, failures=check(result, gate))
        print(f"{name}: eval MPJPE " + " ".join(
            f"{x:.1f}" for x in curves["eval_mpjpe_per_epoch"])
            + "; train loss " + " ".join(
                f"{x:.4f}" for x in curves["train_loss_per_epoch"])
            + f"; checks {out[name]['failures'] or 'passed'}")
    os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
