"""A data-parallel dry run over n ranks (counterpart of
`__graft_entry__.py:59` `dryrun_multichip`):

    python -m gator_tpu_torch.parallel.dryrun --n 4 [--device cpu]

n processes, one per card over NCCL (or over gloo on the CPU with
--device cpu), run the data-parallel surfaces at tiny shapes (640
vertices, depth 2, embed 64 as dryrun_multichip): the stage-2 step on a
global batch of 2n;
sharded eval; sharded serving on a ragged batch of n + 1, padded, equal
to the unsharded path; the `full`-mode step; the packed and device coco
steps on the synthetic H36M + COCO + MuCo mix; the mesh-cache step, equal
to the device step within rtol 1e-5. Every loss is finite and equal on
every rank. It prints one line, as `dryrun_multichip` does; the K-step
scan and the multi-slice mesh are not ported, and the line says so.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

V = 640
EMBED = 64
# the ranks are killed, and the run fails, after this many seconds
TIMEOUT_S = 600


def _cfg(n: int, train_list, joints: str, use_gt: bool, mode: str,
         mesh_cache: str = "off", alpha: bool = False):
    from ..config import load_config
    return load_config(None, {
        "seed": 0,
        "DATASET": {"train_list": list(train_list), "test_list": ["PW3D"],
                    "input_joint_set": joints,
                    "target_joint_set": "human36", "use_gt_input": use_gt},
        "MODEL": {"name": "GATOR", "embed_dim": EMBED, "depth": 2,
                  "alpha": alpha},
        "TRAIN": {"batch_size": 2 * n, "gt_in_step": mode,
                  "gt_mesh_cache": mesh_cache, "precision": "float32"},
        "AUG": {"flip": True, "rotate_factor": 30.0}})


def _rank(world):
    """Every surface on this rank -> the losses and checks it saw."""
    from ..assets import build_assets
    from .checks import run_cases
    from .world import pad_to_multiple

    n = world.size
    b = 2 * n
    h36, coco = (build_assets(js, data_dirs=[], synthetic_vertex_num=V,
                              seed=0) for js in ("human36", "coco"))
    rng = np.random.default_rng(0)
    batch = {
        "pose2d": rng.normal(size=(b, 17, 2)).astype(np.float32),
        "mesh": rng.normal(size=(b, V, 3)).astype(np.float32) * 0.1,
        "lift_pose3d": rng.normal(size=(b, 17, 3)).astype(np.float32),
        "reg_pose3d": rng.normal(size=(b, 17, 3)).astype(np.float32),
        "mesh_valid": np.ones((b, V, 1), np.float32),
        "lift_valid": np.ones((b, 17, 1), np.float32),
        "reg_valid": np.ones((b, 17, 1), np.float32),
    }
    spec = {"embed_dim": EMBED, "depth": 2}
    ragged, real = pad_to_multiple(
        rng.normal(size=(n + 1, 17, 2)).astype(np.float32), n)
    mix = ("Human36M", "COCO", "MuCo")
    step, ev, served = run_cases(world, [
        {"kind": "step", "assets": h36, "spec": spec, "batch": batch},
        {"kind": "eval", "assets": h36, "spec": spec, "batches": [batch]},
        {"kind": "serve", "assets": h36, "spec": spec, "poses": ragged}])
    # the unsharded path on this rank's replica of the same padded batch
    unsharded = run_cases(None, [{"kind": "serve", "assets": h36,
                                  "spec": spec, "poses": ragged,
                                  "device": world.device}])[0]
    serve_err = float(np.abs(served["mesh"][:real]
                             - unsharded["mesh"][:real]).max())
    full, packed, device, cached = run_cases(world, [
        {"kind": "session", "assets": h36, "synthetic_n": 4 * b,
         "cfg": _cfg(n, ["Human36M"], "human36", True, "full")},
        {"kind": "session", "assets": coco, "synthetic_n": 2 * b,
         "cfg": _cfg(n, mix, "coco", False, "packed", alpha=True)},
        {"kind": "session", "assets": coco, "synthetic_n": 2 * b,
         "cfg": _cfg(n, mix, "coco", False, "device", alpha=True)},
        {"kind": "session", "assets": coco, "synthetic_n": 2 * b,
         "cfg": _cfg(n, mix, "coco", False, "device", "on", alpha=True)}])
    return {"loss": step["metrics"]["loss"], "eval_mpjpe": ev["joint_err"],
            "eval_count": ev["count"], "serving_shape": served["mesh"][
                :real].shape, "serving_err": serve_err,
            "modes": [full["mode"], packed["mode"], device["mode"]],
            "full": full["metrics"]["loss"],
            "packed": packed["metrics"]["loss"],
            "device": device["metrics"]["loss"],
            "cache": cached["metrics"]["loss"]}


def dryrun_multigpu(n: int, device: str = "cuda") -> str:
    """Run the surfaces over n ranks (NCCL with one card per rank, or gloo
    with device "cpu") -> the printed line. Raises where a check fails, and
    on the card where the host has fewer than n cards."""
    from .world import spawn

    if device == "cpu":
        backend, devices = "gloo", "cpu"
    else:
        cards = torch.cuda.device_count()
        if cards < n:
            raise RuntimeError(f"dryrun_multigpu({n}) on the card needs "
                               f"{n} cards; this host has {cards}")
        backend, devices = "nccl", [f"cuda:{r}" for r in range(n)]
    ranks = spawn(_rank, n, backend=backend, devices=devices,
                  timeout=TIMEOUT_S)
    r0 = ranks[0]
    for key in ("loss", "eval_mpjpe", "full", "packed", "device", "cache"):
        vals = [r[key] for r in ranks]
        if not np.isfinite(vals).all() or len(set(vals)) != 1:
            raise AssertionError(f"{key} differs over the ranks or is not "
                                 f"finite: {vals}")
    if r0["eval_count"] != 2 * n:
        raise AssertionError(f"eval count {r0['eval_count']} != {2 * n}")
    if tuple(r0["serving_shape"]) != (n + 1, V, 3) \
            or r0["serving_err"] > 1e-5:
        raise AssertionError(f"sharded serving {r0['serving_shape']}, "
                             f"{r0['serving_err']} m from unsharded")
    if r0["modes"] != ["full", "packed", "device"]:
        raise AssertionError(f"input modes {r0['modes']}")
    np.testing.assert_allclose(r0["cache"], r0["device"], rtol=1e-5)
    line = (f"dryrun_multigpu({n}): ok, loss={r0['loss']:.4f}, "
            f"eval_mpjpe={r0['eval_mpjpe']:.2f}, "
            f"sharded_serving={tuple(r0['serving_shape'])}, "
            f"device_pipeline_loss={r0['full']:.4f}, "
            f"packed_det_loss={r0['packed']:.4f}, "
            f"device_det_loss={r0['device']:.4f}, "
            f"mesh_cache_loss={r0['cache']:.4f}, "
            f"world={n} ranks over {backend} on {device}, "
            f"k_step_scan=not ported, multi_slice_loss=not ported")
    print(line, flush=True)
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cpu", "cuda"))
    a = p.parse_args(argv)
    return dryrun_multigpu(a.n, a.device)


if __name__ == "__main__":
    # through the package's module, so that the ranks import it by name
    from gator_tpu_torch.parallel.dryrun import main as _main
    _main()
