"""Rank-side functions of the data-parallel checks: each runs one case on
this process's rows (with a `world`) or on the whole batch (world None),
and returns what a caller holds against the other: the metrics, every
parameter's gradient after the all-reduce, the parameters after the
optimizer step, the BatchNorm running stats, an eval result or served
meshes. `spawn(run_cases, n, args=(cases,))` runs them over n ranks, and
`run_cases(None, cases)` runs the one-process counterpart on the global
batch. chip_smoke.py (phase 30), `parallel.dryrun` and the CPU tests use
them.

A case is a dict. Every kind takes "assets" (a port asset bundle) and
"device" (for world None; a rank takes its world's). Kinds:
  * "step": one train step. "stage" ("gator" or "gat"), "spec" (keyword
    arguments of the spec's `from_assets`), "model_seed" or "state_dict"
    (numpy), "batch" (the global batch, numpy), "dtype", "rates" (the LBF
    rates; None for the spec's), "gat_mlp_rate", "seed", "lr", and
    "time_steps": that many more steps after the checked one, each timed
    on the host clock to a synchronize ("step_ms"); the result also
    carries the K4/K5 launches of the checked step ("launches");
  * "session": one step of a training `cli.common.Session` on the
    pipeline's first batch: "cfg" (a Config), "synthetic_n", "seed",
    "lr";
  * "eval": `run_eval` of the GATOR eval step over "batches" (a list of
    numpy batches, ragged allowed) with "collect_out" / "collect_batch";
  * "serve": the (sharded) serving function on "poses" in "dtype";
  * "bn": the MDR head's BatchNorm statistics alone: "x" [B, C, 3] and
    the output cotangent "g", with "running" (mean, var);
  * "train_cli", "test_cli", "serve_cli": `cli.train.run_train`,
    `cli.test.run_test` and `cli.serve.run_serve` with "kwargs", on
    synthetic data, -> {"result", "stdout"}; "term_epoch" and
    "term_rank" make that rank raise SIGTERM in itself when the training
    pipeline starts that epoch (a preemption of one rank at a known
    point).
"""
from __future__ import annotations

import contextlib
import io
import signal
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import losses
from ..cli.common import Session
from ..models import GatorSpec, GatSpec, build_gat, build_gator
from ..serving import make_serving_fn, make_sharded_serving_fn
from ..train import (Adam, TrainState, make_gat_train_step,
                     make_gator_eval_step, make_gator_train_step, run_eval)
from ..train.fused_forward import batch_stats
from .world import _to_host, broadcast_module, local_rows


def _device(world, case) -> torch.device:
    return world.device if world is not None \
        else torch.device(case.get("device", "cpu"))


def _model(case, device):
    assets = case["assets"]
    if case.get("stage", "gator") == "gat":
        spec = GatSpec.from_assets(assets, **case["spec"])
        model = build_gat(spec, seed=case.get("model_seed", 0), device="cpu")
    else:
        spec = GatorSpec.from_assets(assets, **case["spec"])
        model = build_gator(spec, seed=case.get("model_seed", 0),
                            device="cpu")
    if case.get("state_dict") is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in case["state_dict"].items()},
                              strict=True)
    return spec, model.to(device)


def _after_step(state, metrics) -> Dict[str, Any]:
    model = state.model
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: p.grad for n, p in model.named_parameters()
                  if p.grad is not None},
        "params": dict(model.named_parameters()),
        "buffers": dict(model.named_buffers()),
        "step": state.step,
    }


def _launches():
    from ..nn.gat_trunk_train import gat_trunk_train as k5
    from ..nn.lbf_stack_train import lbf_stack_train as k4
    return {"gat_trunk_train": k5.launches_fwd + k5.launches_bwd,
            "lbf_stack_train": k4.launches_fwd + k4.launches_bwd}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step(world, case):
    device = _device(world, case)
    spec, model = _model(case, device)
    broadcast_module(model, world)
    dtype = getattr(torch, case.get("dtype", "float32"))
    assets = case["assets"]
    if case.get("stage", "gator") == "gat":
        step = make_gat_train_step(spec, dtype=dtype,
                                   mlp_rate=case.get("gat_mlp_rate", 0.1),
                                   world=world)
        extra = (case.get("seed", 0),)
    else:
        step = make_gator_train_step(
            spec, assets.faces, assets.j_regressor_h36m,
            losses.LossWeights(), dtype=dtype, rates=case.get("rates"),
            gat_mlp_rate=case.get("gat_mlp_rate", 0.1), world=world)
        extra = (case.get("seed", 0), 1.0)
    state = TrainState(model, Adam(model.parameters(),
                                   lr=case.get("lr", 1e-4)))
    batch = local_rows({k: np.asarray(v) for k, v in case["batch"].items()},
                       world)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    before = _launches()
    with torch.enable_grad():
        metrics = step(state, batch, *extra)
        _sync(device)
        out = _to_host(_after_step(state, metrics))
        out["launches"] = {k: v - before[k]
                           for k, v in _launches().items()}
        out["step_ms"] = []
        for _ in range(case.get("time_steps", 0)):
            t0 = time.perf_counter()
            step(state, batch, *extra)
            _sync(device)
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def _session_step(world, case):
    sess = Session(case["cfg"], synthetic=True, assets=case["assets"],
                   synthetic_n=case.get("synthetic_n", 16),
                   device=case.get("device", "cpu"), is_train=True,
                   world=world)
    state, step = sess.make_train_step(
        lambda params: Adam(params, lr=case.get("lr", 1e-4)))
    it = iter(sess.pipeline)
    batch = next(it)
    it.close()
    extra = (case.get("seed", 0), 1.0) if sess.is_gator \
        else (case.get("seed", 0),)
    with torch.enable_grad():
        metrics = step(state, batch, *extra)
    out = _after_step(state, metrics)
    out["mode"] = sess.gt_in_step
    return out


def _eval(world, case):
    device = _device(world, case)
    _, model = _model(case, device)
    assets = case["assets"]
    estep = make_gator_eval_step(assets.j_regressor_h36m,
                                 assets.joint_set.eval_joints)
    return run_eval(estep, model, case["batches"],
                    collect_out=case.get("collect_out", ()),
                    collect_batch=case.get("collect_batch", ()),
                    world=world)


def _serve(world, case):
    device = _device(world, case)
    _, model = _model(case, device)
    dtype = getattr(torch, case.get("dtype", "float32"))
    poses = torch.as_tensor(np.asarray(case["poses"]), device=device)
    if world is None:
        fn = make_serving_fn(model, dtype=dtype)
    else:
        fn = make_sharded_serving_fn(model, world, dtype=dtype)
    mesh, pose3d = fn(poses)
    return {"mesh": mesh.float(), "pose3d": pose3d.float()}


def _bn(world, case):
    device = _device(world, case)
    x = torch.as_tensor(local_rows(np.asarray(case["x"]), world),
                        device=device).requires_grad_(True)
    g = torch.as_tensor(local_rows(np.asarray(case["g"]), world),
                        device=device)
    with torch.enable_grad():
        mean, var = batch_stats(x, world)
        y = (x - mean[None, :, None]) * torch.rsqrt(var[None, :, None]
                                                    + 1e-5)
        (y * g).sum().backward()
    rm, rv = (torch.as_tensor(np.asarray(t), device=device)
              for t in case["running"])
    return {"y": y, "dx": x.grad, "running_mean": 0.9 * rm + 0.1 * mean,
            "running_var": 0.9 * rv + 0.1 * var}


@contextlib.contextmanager
def _sigterm_at(epoch):
    """SIGTERM to this process when a training pipeline (drop_last) starts
    `epoch`."""
    from ..data.pipeline import BatchPipeline
    set_epoch = BatchPipeline.set_epoch

    def hooked(self, e):
        set_epoch(self, e)
        if e == epoch and self.drop_last:
            signal.raise_signal(signal.SIGTERM)

    BatchPipeline.set_epoch = hooked
    try:
        yield
    finally:
        BatchPipeline.set_epoch = set_epoch


def _cli(world, case):
    from ..cli import serve, test, train
    from ..config import load_config
    kw = dict(case["kwargs"])
    kw["world"] = world
    if case["kind"] == "serve_cli":
        run = serve.run_serve
    else:
        kw["cfg"] = load_config(kw["cfg"])
        run = train.run_train if case["kind"] == "train_cli" \
            else test.run_test
    rank = 0 if world is None else world.rank
    term = case.get("term_epoch") is not None \
        and rank == case.get("term_rank", 0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            (_sigterm_at(case["term_epoch"]) if term
             else contextlib.nullcontext()):
        result = run(**kw)
    return {"result": result, "stdout": out.getvalue()}


_KINDS = {"step": _step, "session": _session_step, "eval": _eval,
          "serve": _serve, "bn": _bn, "train_cli": _cli, "test_cli": _cli,
          "serve_cli": _cli}


def run_cases(world, cases: List[Dict[str, Any]]) -> List[Any]:
    """Each case in order (module docstring) -> its result, tensors as
    numpy arrays."""
    return [_to_host(_KINDS[case["kind"]](world, case)) for case in cases]
