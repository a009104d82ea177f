"""Convert a checkpoint that gator_tpu trained (an orbax directory) into a
`.pth.tar` that gator_tpu_torch loads.

    python tools/jax_checkpoint_to_torch.py results/run/best out.pth.tar
    python tools/jax_checkpoint_to_torch.py results/run out.pth.tar

The source is a concrete checkpoint (`best/`, `final/`, `checkpoint{N}/`,
marked by orbax's `_CHECKPOINT_METADATA`) or a container of them, which
resolves as gator_tpu's eval CLI resolves it: best first, then whichever of
final and the highest checkpoint{N} is further along
(gator_tpu/cli/test.py:42-55). The flax `params` and `batch_stats` map
through `gator_tpu_torch.convert.state_dict_from_jax`; the output has the
port's checkpoint layout (gator_tpu_torch/train/checkpoint.py
`save_checkpoint`: epoch, model_state_dict, empty optimizer and scheduler
entries), which the port's CLIs load with `--weights`.

It needs JAX and orbax to read the source, which the port never imports,
so it lives outside both packages and runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def resolve(path: str) -> str:
    """A concrete orbax checkpoint directory for `path`."""
    from gator_tpu.train.checkpoint import pick_checkpoint

    if osp.exists(osp.join(path, "_CHECKPOINT_METADATA")):
        return path
    return pick_checkpoint(path, pick_best=True)


def convert(src: str, dst: str) -> str:
    """Read the orbax checkpoint at (or under) `src`, write `dst`; -> the
    concrete source directory read."""
    import jax
    import numpy as np
    import torch

    from gator_tpu.train.checkpoint import load_checkpoint
    from gator_tpu_torch.convert import state_dict_from_jax

    jax.config.update("jax_platforms", "cpu")
    concrete = resolve(src)
    restored = load_checkpoint(concrete)
    state = restored["state"]
    variables = {"params": state["params"]}
    if state.get("batch_stats"):
        variables["batch_stats"] = state["batch_stats"]
    variables = jax.tree_util.tree_map(np.asarray, variables)
    os.makedirs(osp.dirname(osp.abspath(dst)), exist_ok=True)
    torch.save({
        "epoch": int(restored["epoch"]),
        "model_state_dict": state_dict_from_jax(variables),
        "optim_state_dict": {},
        "scheduler_state_dict": {},
        "train_log": [],
        "test_log": {},
    }, dst)
    return concrete


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="orbax checkpoint dir, or a container of "
                               "them (best/, final/, checkpoint{N}/)")
    p.add_argument("dst", help="output .pth.tar")
    a = p.parse_args(argv)
    concrete = convert(a.src, a.dst)
    print(f"{concrete} -> {a.dst}")
    return a.dst


if __name__ == "__main__":
    main()
