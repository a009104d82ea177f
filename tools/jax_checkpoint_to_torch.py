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
`save_checkpoint`), which the port's CLIs load with `--weights`. The rest
of the run comes along, so that the port's train CLI continues it with
`--resume_training` (put the file in <exp_dir>/checkpoint/ under its
checkpoint{N}.pth.tar name): the train step; the optimizer state, keyed
by the port's parameter names (`optimizer_state`: optax.adam's mu, nu and
count, the nesterov SGD trace, the RMSprop nu, each plain or under
inject_hyperparams, whose injected lr becomes the param group's lr); the
plateau controller's state; and the train and test histories.

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


def _find(tree, pred):
    """The first dict in a restored optax state (nested dicts and lists),
    depth first, for which `pred` holds, or None."""
    if isinstance(tree, dict):
        if pred(tree):
            return tree
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    else:
        return None
    for item in items:
        found = _find(item, pred)
        if found is not None:
            return found
    return None


def optimizer_state(opt_state) -> dict:
    """A restored optax state -> a torch optimizer state dict keyed by
    the port's parameter names (gator_tpu_torch.train.load_checkpoint
    maps them to indices): per parameter Adam's {"step", "mu", "nu"}
    (gator_tpu_torch.train.Adam), SGD's {"momentum_buffer"} (optax's
    trace, which torch's nesterov SGD keeps as its buffer) or RMSprop's
    {"nu"}; one param group with the injected lr where there is one. Empty
    for a transform that keeps no state (plain SGD)."""
    from gator_tpu_torch.convert import state_dict_from_jax

    def named(tree):
        return state_dict_from_jax({"params": tree})

    adam = _find(opt_state, lambda d: {"mu", "nu", "count"} <= set(d))
    trace = _find(opt_state, lambda d: "trace" in d)
    rms = _find(opt_state, lambda d: "nu" in d and "mu" not in d)
    if adam is not None:
        mu, nu = named(adam["mu"]), named(adam["nu"])
        per = {n: {"step": int(adam["count"]), "mu": mu[n], "nu": nu[n]}
               for n in mu}
    elif trace is not None:
        per = {n: {"momentum_buffer": t}
               for n, t in named(trace["trace"]).items()}
    elif rms is not None:
        per = {n: {"nu": v} for n, v in named(rms["nu"]).items()}
    else:
        return {}
    group = {"params": list(per)}
    hyper = _find(opt_state, lambda d: "hyperparams" in d)
    if hyper is not None:
        group["lr"] = float(hyper["hyperparams"]["learning_rate"])
    return {"state": per, "param_groups": [group]}


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
    sched = {k: float(v) for k, v in (restored.get("scheduler")
                                      or {}).items()}
    if "num_bad_epochs" in sched:
        sched["num_bad_epochs"] = int(sched["num_bad_epochs"])
    os.makedirs(osp.dirname(osp.abspath(dst)), exist_ok=True)
    torch.save({
        "epoch": int(restored["epoch"]),
        "model_state_dict": state_dict_from_jax(variables),
        "optim_state_dict": optimizer_state(jax.tree_util.tree_map(
            np.asarray, state.get("opt_state"))),
        "scheduler_state_dict": sched,
        "train_log": [float(x) for x in restored.get("train_log", [])],
        "test_log": {k: [float(x) for x in v] for k, v in
                     (restored.get("test_log") or {}).items()},
        "step": int(state["step"]),
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
