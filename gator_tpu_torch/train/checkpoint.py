"""Checkpoints with torch.save (counterpart of gator_tpu/train/checkpoint.py,
which writes orbax directories). The layout is the reference's
(lib/funcs_utils.py:110-127, driven from main/train.py:44-58): one
`.pth.tar` file of {epoch, model_state_dict, optim_state_dict,
scheduler_state_dict, train_log, test_log}, named checkpoint{N}, final or
best, so the reference's released files and the port's load the same way.
A training run's checkpoint also carries the train step under a seventh
key, "step" (the reference's loader reads the six by name and ignores it):
the step keys each update's dropout masks and the step schedule's
boundaries, so a resumed run needs it (`load_checkpoint(path,
target_state=...)`, counterpart of gator_tpu/train/checkpoint.py:60-83).
Under data parallelism (`world=`) rank 0 alone writes, and every rank waits
at a barrier after it, so that no rank reads a checkpoint before it is
whole; every rank loads.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Optional

import torch

from ..parallel import barrier


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module, epoch: int,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    train_log=None, test_log=None, is_best: bool = False,
                    is_final: bool = False,
                    scheduler_state: Optional[Dict[str, Any]] = None,
                    step: Optional[int] = None, world=None) -> str:
    """Write checkpoint{epoch}.pth.tar (or final.pth.tar), and best.pth.tar
    too when `is_best`; -> the path written. `step`: the train step, saved
    under "step" when given. With a `world`, rank 0 writes and every rank
    returns after the write (a barrier)."""
    name = "final" if is_final else f"checkpoint{epoch}"
    path = osp.abspath(osp.join(ckpt_dir, f"{name}.pth.tar"))
    if world is not None and not world.is_main:
        barrier(world)
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "model_state_dict": model.state_dict(),
        "optim_state_dict": (optimizer.state_dict()
                             if optimizer is not None else {}),
        "scheduler_state_dict": dict(scheduler_state or {}),
        "train_log": list(train_log or []),
        "test_log": {k: list(v) for k, v in (test_log or {}).items()},
    }
    if step is not None:
        payload["step"] = int(step)
    torch.save(payload, path)
    if is_best:
        torch.save(payload, osp.join(ckpt_dir, "best.pth.tar"))
    barrier(world)
    return path


def load_checkpoint(path: str, target_state=None) -> Dict[str, Any]:
    """The checkpoint's dict, tensors on the CPU. Reference files carry
    more than tensors, so this unpickles: load only files you trust.

    With a `target_state` (a `TrainState`), the run is restored into it
    and returned under "state": the model's parameters and persistent
    buffers (the BatchNorm running stats), strictly, a DataParallel
    "module." prefix stripped; the optimizer's state, moved to the
    parameters' device (its param groups' lr too: the plateau path's lr);
    the step (0 where the file has none). The plateau state and the
    histories stay in the dict ("scheduler_state_dict", "train_log",
    "test_log"). The optimizer state may be keyed by parameter names (as
    tools/jax_checkpoint_to_torch.py writes it) instead of torch's
    indices."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if target_state is None:
        return ckpt
    model, opt = target_state.model, target_state.optimizer
    model.load_state_dict(_strip_module(ckpt["model_state_dict"]),
                          strict=True)
    osd = ckpt.get("optim_state_dict") or {}
    if osd:
        opt.load_state_dict(_indexed(osd, model, opt))
    target_state.step = int(ckpt.get("step", 0))
    ckpt["state"] = target_state
    return ckpt


def _strip_module(state: Dict[str, Any]) -> Dict[str, Any]:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


def _indexed(osd: Dict[str, Any], model: torch.nn.Module,
             opt: torch.optim.Optimizer) -> Dict[str, Any]:
    """An optimizer state dict keyed by parameter names -> torch's form
    (indices in `model.named_parameters()` order, which is the order the
    optimizer was given them in); a saved group's hyperparameters go over
    the optimizer's own, so a group may name only its lr. Torch's own form
    passes through."""
    groups = osd["param_groups"]
    if not any(isinstance(p, str) for g in groups for p in g["params"]):
        return osd
    index = {n: i for i, (n, _) in
             enumerate(model.named_parameters())}
    unknown = sorted(set(osd["state"]) - set(index))
    if unknown:
        raise KeyError(f"optimizer state for unknown parameters {unknown}")
    own = opt.state_dict()["param_groups"]
    if len(own) != len(groups):
        raise ValueError(f"{len(groups)} saved param groups, the optimizer "
                         f"has {len(own)}")
    return {"state": {index[n]: v for n, v in osd["state"].items()},
            "param_groups": [{**g_own, **{k: v for k, v in g.items()
                                          if k != "params"}}
                             for g_own, g in zip(own, groups)]}


def _epoch_of(name: str) -> Optional[int]:
    stem = name[:-len(".pth.tar")] if name.endswith(".pth.tar") else None
    if stem and stem.startswith("checkpoint") and \
            stem[len("checkpoint"):].isdigit():
        return int(stem[len("checkpoint"):])
    return None


def pick_checkpoint(ckpt_dir: str, pick_best: bool = False) -> str:
    """best (when asked and present), else whichever of final and the
    highest checkpoint{N} is further along (an extended run may leave
    checkpoints newer than final); reference: base.py:69, GAT.py:128-131."""
    best = osp.join(ckpt_dir, "best.pth.tar")
    if pick_best and osp.isfile(best):
        return best
    nums = [n for n in map(_epoch_of, os.listdir(ckpt_dir)) if n is not None]
    final = osp.join(ckpt_dir, "final.pth.tar")
    if osp.isfile(final) and (
            not nums or load_checkpoint(final)["epoch"] >= max(nums)):
        return final
    if not nums:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return osp.join(ckpt_dir, f"checkpoint{max(nums)}.pth.tar")


# Leaf names of the reference model's non-parameter buffers (graph
# tables, template vertices), which the port rebuilds from its assets as
# non-persistent buffers; the same names as the JAX converter's
# `_is_buffer` (gator_tpu/convert/torch_loader.py).
REFERENCE_BUFFERS = ("graph_adj", "init_vertices", "init_vertices_6890",
                     "adj", "spatial", "spatial_pos", "edg_adj")


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a model's weights, strictly, from a checkpoint file (the
    reference layout, or a bare state dict), or from a directory of them
    (best first, as the eval CLI picks; `pick_checkpoint`). A DataParallel
    "module." prefix is stripped, and so are the reference's buffer keys
    (`REFERENCE_BUFFERS`) that the model does not hold: a released
    `.pth.tar` carries four. MotionBERT's layout ({"model": ...}) and HMR
    2.0's Lightning one ({"state_dict": ...}) load too, without the keys
    the model's `checkpoint_ignored` prefixes name (their SMPL layers'
    tables, HMR 2.0's discriminator). Any other unknown or missing key
    raises."""
    if osp.isdir(path):
        path = pick_checkpoint(path, pick_best=True)
    state = load_checkpoint(path)
    for layout in ("model", "state_dict"):
        if isinstance(state.get(layout), dict):
            state = state[layout]
    state = _strip_module(state.get("model_state_dict", state))
    own = model.state_dict()
    ignored = getattr(model, "checkpoint_ignored", ())
    state = {k: v for k, v in state.items()
             if (k in own or k.split(".")[-1] not in REFERENCE_BUFFERS)
             and not k.startswith(ignored)}
    model.load_state_dict(state, strict=True)
    return model
