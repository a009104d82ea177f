"""The stage-2 train step's levers on one CUDA device (counterpart of
tools/exp_train_ablate.py):

    python -m gator_tpu_torch.tools.exp_train_ablate
        [--batches 256 512 1024 2048] [--batch 512]
        [--out build/train_ablation.json] [--device cpu]

Full stage-2 steps (forward, backward, losses, Adam) of the full-width
synthetic human36 model (seeded random weights) on a fixed batch of the
training shapes:
  * bf16 on K4/K5 at each batch of --batches (the baseline at --batch);
  * forward plus loss with no grad (`step.forward_loss`) at --batch;
  * dropout off: every LBF rate, GatMlp's and the GAT spec's rates 0;
  * the plain version of K5 alone (K4 stays), the counterpart of the JAX
    tool's "flax-GAT-trunk";
  * the plain versions of K4 and K5 in bf16 and in f32
    (`make_gator_train_step(use_kernels=False)`), the counterpart of its
    "XLA" paths; the K4/K5 launch counters must stay still through them.
Per variant: host ms a step (median of synchronised steps), device-busy
ms, kernel launches and the idle share (torch.profiler), and poses/s.
Also the JAX tool's `derived` block (the forward's and the backward's
shares) and, from the batch sweep, host and device ms a step against B
with a least-squares fit ms = fixed + per_sample * B: a fixed part that
does not shrink with B is host work per step. `not_ported` names the JAX
levers with no meaning here. Writes all of it to --out. Without a CUDA
device it fails unless --device cpu is given (then host ms only, at
--vertex_num and --depth the caller picks).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

BATCHES = (256, 512, 1024, 2048)
SEED = 7
NOT_PORTED = {
    "group_fwd=2/8, group_bwd=2": "Mosaic grid grouping of the TPU "
                                  "kernels' samples; K4/K5 plan their own "
                                  "tiles from B",
    "XLA f32 remat, XLA bf16 remat": "the module form with jax.checkpoint "
                                     "is not ported (ROADMAP, Not ported); "
                                     "K4/K5 save their activations",
}


def make_batch(b, j, v):
    """The JAX tool's `make_batch`: seeded training shapes."""
    rng = np.random.default_rng(1)
    return {
        "pose2d": rng.normal(size=(b, j, 2)).astype(np.float32),
        "mesh": rng.normal(size=(b, v, 3)).astype(np.float32) * 0.1,
        "lift_pose3d": rng.normal(size=(b, j, 3)).astype(np.float32) * 100,
        "reg_pose3d": rng.normal(size=(b, 17, 3)).astype(np.float32) * 100,
        "mesh_valid": np.ones((b, v, 1), np.float32),
        "lift_valid": np.ones((b, j, 1), np.float32),
        "reg_valid": np.ones((b, 17, 1), np.float32),
    }


def variants(batches=BATCHES, batch=512) -> dict:
    """{name: (B, make_gator_train_step kwargs, forward only?, spec rates
    off?)}, the JAX tool's names where it has the variant."""
    bf16 = dict(dtype=torch.bfloat16)
    out = {}
    for b in batches:
        out["bf16 (baseline)" if b == batch else f"bf16 B={b}"] = (
            b, bf16, False, False)
    out["bf16 fwd-only (no grad)"] = (batch, bf16, True, False)
    out["bf16 dropout-off"] = (batch, dict(bf16, rates=(0.0,) * 6,
                                           gat_mlp_rate=0.0), False, True)
    out["bf16 plain K5 (flax-GAT-trunk)"] = (
        batch, dict(bf16, gat_kernel=False), False, False)
    out["plain f32 (XLA f32)"] = (batch, dict(dtype=torch.float32,
                                              use_kernels=False), False,
                                  False)
    out["plain bf16 (XLA bf16)"] = (batch, dict(bf16, use_kernels=False),
                                    False, False)
    return out


def _counts():
    from ..nn.gat_trunk_train import gat_trunk_train
    from ..nn.lbf_stack_train import lbf_stack_train
    return (gat_trunk_train.launches_fwd + gat_trunk_train.launches_bwd,
            lbf_stack_train.launches_fwd + lbf_stack_train.launches_bwd)


def fit(points) -> dict:
    """Least squares ms = fixed_ms + per_sample_ms * B over (B, ms)."""
    b, ms = (np.asarray(v, np.float64) for v in zip(*points))
    per, fixed = np.polyfit(b, ms, 1)
    return {"fixed_ms": float(fixed), "per_sample_ms": float(per)}


def run(device="cuda", batches=BATCHES, batch=512, vertex_num=6890,
        depth=6, reps=5, only=None) -> dict:
    """Every variant (or those named in `only`) -> {"variants": {name:
    {batch, host_ms, device_ms, launches, idle_share, poses_per_sec,
    loss}}, "derived", "sweep"}."""
    from .. import losses
    from ..assets import build_assets
    from ..models import GatorSpec, build_gator
    from ..train import Adam, TrainState, make_gator_train_step
    from .timing import measure

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    assets = build_assets("human36", data_dirs=[],
                          synthetic_vertex_num=vertex_num, seed=0)
    spec = GatorSpec.from_assets(assets, depth=depth)
    model = build_gator(spec, seed=0, device=dev)
    state = TrainState(model, Adam(model.parameters(), lr=1e-4))
    j, v = spec.gat.num_joint, spec.mdr.full_num
    results = {}
    for name, (b, kw, fwd_only, spec_off) in variants(batches,
                                                       batch).items():
        if only is not None and name not in only:
            continue
        vspec = spec
        if spec_off:
            vspec = dataclasses.replace(spec, gat=dataclasses.replace(
                spec.gat, drop_rate=0.0, attn_drop_rate=0.0,
                drop_path_rate=0.0))
        step = make_gator_train_step(vspec, assets.faces,
                                     assets.j_regressor_h36m,
                                     losses.LossWeights(), **kw)
        data = {k: torch.from_numpy(a).to(dev)
                for k, a in make_batch(b, j, v).items()}
        last = {}

        def call():
            # whatever the caller's grad mode (chip_smoke runs with it off)
            with torch.set_grad_enabled(not fwd_only):
                if fwd_only:
                    last["loss"] = step.forward_loss(state, data, SEED,
                                                     1.0)[0].total
                else:
                    last["loss"] = step(state, data, SEED, 1.0)["loss"]

        before = _counts()
        got = measure(call, cuda, reps)
        # a plain version on CUDA tensors launches no kernel of its own
        after = _counts()
        k5_still = (kw.get("use_kernels") is False
                    or kw.get("gat_kernel") is False)
        k4_still = kw.get("use_kernels") is False
        if cuda and ((after[0] == before[0]) != k5_still
                     or (after[1] == before[1]) != k4_still):
            raise RuntimeError(f"exp_train_ablate: {name} moved the K5/K4 "
                               f"launch counts {before} -> {after}")
        loss = float(last["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"exp_train_ablate: {name} loss {loss}")
        results[name] = {"batch": b, **got, "loss": loss,
                         "poses_per_sec": b / got["host_ms"] * 1e3}
    out = {"variants": results}
    base = results.get("bf16 (baseline)")
    fwd = results.get("bf16 fwd-only (no grad)")
    if base and fwd:
        vjp_ms = base["host_ms"] - fwd["host_ms"]
        out["derived"] = {
            "fwd_share_ms": fwd["host_ms"],
            "vjp_share_ms": vjp_ms,
            # the JAX tool's bound for a save-activations backward (its
            # kernels recompute the forward); K4/K5 already save theirs,
            # so here it bounds what removing the forward would give
            "save_activations_max_gain_ms": fwd["host_ms"],
            "save_activations_max_speedup": base["host_ms"] / vjp_ms
            if vjp_ms > 0 else None,
        }
    sweep = sorted((r["batch"], r) for n, r in results.items()
                   if n == "bf16 (baseline)" or n.startswith("bf16 B="))
    if len(sweep) >= 2:
        out["sweep"] = {
            "host_ms_by_batch": {b: r["host_ms"] for b, r in sweep},
            "device_ms_by_batch": {b: r["device_ms"] for b, r in sweep},
            "host_fit": fit([(b, r["host_ms"]) for b, r in sweep]),
            "device_fit": (fit([(b, r["device_ms"]) for b, r in sweep])
                           if cuda else None),
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--vertex_num", type=int, default=6890)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/train_ablation.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("exp_train_ablate: no CUDA device")
    card = None
    if args.device == "cuda":
        from .timing import card_name
        card = card_name()
    res = run(args.device, args.batches, args.batch, args.vertex_num,
              args.depth, args.reps)
    res.update(card=card, device=args.device, not_ported=NOT_PORTED,
               vertex_num=args.vertex_num, depth=args.depth)
    print(f"stage-2 step variants on {card or 'the CPU (host clock)'}:")
    for name, r in res["variants"].items():
        dev = ("" if r["device_ms"] is None else
               f", device busy {r['device_ms']:.3f} ms, "
               f"{r['launches']:.0f} launches, idle "
               f"{r['idle_share']:.3f}")
        print(f"  {name:34s} B={r['batch']:<5d} host {r['host_ms']:9.3f} "
              f"ms{dev}, {r['poses_per_sec']:10.0f} poses/s")
    if "sweep" in res:
        print(f"  host ms against B: {res['sweep']['host_fit']}")
        if res["sweep"]["device_fit"]:
            print(f"  device ms against B: {res['sweep']['device_fit']}")
    if "derived" in res:
        print(f"  derived: {res['derived']}")
    print(f"  not ported: {', '.join(NOT_PORTED)}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print("->", args.out)
    return res


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
