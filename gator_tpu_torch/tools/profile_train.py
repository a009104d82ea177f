"""Where the time of a training step goes, on one CUDA device.

    python -m gator_tpu_torch.tools.profile_train [--stage 2]
        [--out build/profile_train.json]
    python -m gator_tpu_torch.tools.profile_train --split main losses gat
        [--batch 512] [--out build/profile_train_split.json] [--device cpu]

Builds the full-width synthetic human36 model (seeded random weights), runs
three warm-up steps of the stage-2 (or stage-1) train step at B=512 in
bf16 (the JAX package's TRAIN_BATCH, bench.py:58) on a fixed batch of
bench.py's training shapes, times five steps on the host clock, then
profiles five more with
torch.profiler (CPU and CUDA activities). Prints the step time on the host
clock (synchronised), the device time per kernel group (each launch of
K5 and of K4, K4's and K5's gradient reductions apart, and the largest
plain-torch kernels), the device's busy and idle shares of the profiled
window, and for each of the step's spans (step.forward, step.loss,
step.backward, step.allreduce, step.optimizer; `profiling.attribute`) its
host ms, kernel launches, device ms and the device idle that opens inside
it, per step; writes the same as JSON to --out. Fails without a CUDA
device.

The JSON also holds `kernel_digests`: a sha256 digest of every output,
input gradient, parameter gradient and exported mask of K5 (the six GAT
blocks) and K4 (the three LBF layers), forward and backward at B=512 in
f32 and bf16 at their default rates, seed and sample base, and of K1's
output on the same six blocks, taken on the fresh model before the first
step. The tool calls public entry points
only, so a copy runs in an older tree: run it in both trees in one call,
and equal digests mean bit-equal kernels.

`--split` (the counterpart of tools/profile_fused_train.py, whose three
modes it takes) times the step's parts alone at B=--batch in bf16 on the
same model, each part's device ms, launches and idle share
(torch.profiler) and host ms (`split_parts`):
  * main: the K4 stack's forward alone; its forward and backward against
    a fixed cotangent; the GAT lifter's forward and backward (K5) on a
    loss of its two outputs;
  * losses: the stage-2 losses' forward and backward on a random mesh;
    the MDR's forward and backward (token build, K4 at rate 0, head);
  * gat: the K5 trunk's forward alone, and its forward and backward.
Writes them to --out. Without a CUDA device it fails unless --device cpu
is given (then host ms only, at --vertex_num and --depth).
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import profiling
from .timing import card_name, read_spans

BATCH, STEPS = 512, 5
SPANS = ("step.forward", "step.loss", "step.backward", "step.allreduce",
         "step.optimizer")
GROUPS = (
    ("gat_block_fwd", "K5 forward (gat_block_fwd)"),
    ("gat_block_bwd", "K5 backward, rows (gat_block_bwd)"),
    ("gat_block_wgrad", "K5 backward, weight gradients (gat_block_wgrad)"),
    ("lbf_rows_fwd", "K4 forward, row-local (lbf_rows_fwd)"),
    ("lbf_sa_fwd", "K4 forward, self-attention (lbf_sa_fwd)"),
    ("lbf_sa_bwd_dq", "K4 backward, L3, D and dq2 (lbf_sa_bwd_dq)"),
    ("lbf_sa_bwd_dkv", "K4 backward, dk2/dv2 (lbf_sa_bwd_dkv)"),
    ("lbf_rows_bwd", "K4 backward, row-local (lbf_rows_bwd)"),
    ("lbf_joints_bwd", "K4 backward, joints (lbf_joints_bwd)"),
    ("lbf_wgrad", "K4 backward, weight gradients (lbf_wgrad)"),
    ("lbf_reduce", "K4 gradient reduction (lbf_reduce)"),
    ("reduce_partials", "K5 gradient-partial reduction (reduce_partials)"),
)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _is_kernel(evt) -> bool:
    """A device-side kernel or copy; not a user-annotated range (such as
    the optimizer's), whose device time repeats its kernels'."""
    kind = str(getattr(evt, "device_type", ""))
    return ("CUDA" in kind and _device_us(evt) > 0
            and not getattr(evt, "is_user_annotation", False))


def _digest(t: torch.Tensor) -> str:
    data = t.detach().float().contiguous().cpu().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def kernel_digests(model) -> dict:
    """{"K5 <dtype>" / "K4 <dtype>" / "K1 <dtype>": {name: digest}}
    (module docstring); leaves the model's gradients set."""
    from gator_tpu_torch.nn import fold_trunk_weights, gat_trunk
    from gator_tpu_torch.nn.gat_trunk_train import (extract_block_params,
                                                    gat_trunk_train)
    from gator_tpu_torch.nn.lbf_stack_train import (extract_layer_params,
                                                    lbf_stack_train)

    dev = next(model.parameters()).device
    gat, mdr = model.pose_lifter, model.pose2mesh
    gen = torch.Generator().manual_seed(5)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen).to(dev).to(dtype)

    def digests(y, inputs, module, masks):
        got = {"out": _digest(y)}
        got.update({n: _digest(t.grad) for n, t in inputs.items()})
        got.update({n: _digest(p.grad) for n, p in module.named_parameters()
                    if p.grad is not None})
        got.update({f"mask{i}.{k}": _digest(m) for i, unit in
                    enumerate(masks) for k, m in unit.items()})
        return got

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        c = gat.spec.embed_dim
        x = randn(BATCH, 17, c, dtype=dtype).requires_grad_(True)
        bias = gat.get_hop_path_encoding().detach().float().requires_grad_(
            True)
        cot = randn(BATCH, 17, c, dtype=dtype)
        gat.zero_grad(set_to_none=True)
        masks = []
        y = gat_trunk_train(x, bias, [extract_block_params(b)
                                      for b in gat.blocks],
                            gat.spec.masks_xfeat, gat.spec.num_heads, 1234,
                            export=masks)
        y.backward(cot)
        torch.cuda.synchronize()
        out[f"K5 {dtype}"] = digests(y, {"dx": x, "dbias": bias},
                                     gat.blocks, masks)

        nv = mdr.spec.coarse_num
        x = randn(BATCH, nv, 64, dtype=dtype).requires_grad_(True)
        jt = randn(BATCH, 17, 64, dtype=dtype).requires_grad_(True)
        cot = randn(BATCH, nv, 64, dtype=dtype)
        mdr.zero_grad(set_to_none=True)
        masks = []
        y = lbf_stack_train(x, jt, [extract_layer_params(mdr, i)
                                    for i in range(3)],
                            mdr.spec.num_heads, 4321, export=masks)
        y.backward(cot)
        torch.cuda.synchronize()
        out[f"K4 {dtype}"] = digests(y, {"dx": x, "djt": jt}, mdr, masks)

        # K1, the serving trunk, on the same blocks
        x = randn(BATCH, 17, gat.spec.embed_dim, dtype=dtype)
        with torch.no_grad():
            y = gat_trunk(x, gat.get_hop_path_encoding().float(),
                          gat.blocks[0].x_feat.masks,
                          fold_trunk_weights(gat.blocks, dtype, dev),
                          gat.spec.num_heads)
        torch.cuda.synchronize()
        out[f"K1 {dtype}"] = {"out": _digest(y)}
    return out


SPLIT_MODES = ("main", "losses", "gat")


def stage2_losses(mesh, gt, lift, reg, j_reg, faces):
    """The split's losses part: the stage-2 loss of a mesh [B, V, 3] (m)
    against its targets, all valid, the lift pose as its own target (the
    JAX tool's `loss_of`) -> the total."""
    from gator_tpu_torch import losses
    b, v = mesh.shape[:2]
    ones = torch.ones(b, v, 1, device=mesh.device)
    ones_r = torch.ones(b, reg.shape[1], 1, device=mesh.device)
    ones_l = torch.ones(b, lift.shape[1], 1, device=mesh.device)
    pred = torch.einsum("jv,bvc->bjc", j_reg, mesh * 1000.0)
    return losses.gator_loss(mesh, pred, lift, gt, reg, lift, ones, ones_r,
                             ones_l, faces, losses.LossWeights(), 1.0).total


def split_parts(model, assets, b: int, modes=SPLIT_MODES,
                dtype=torch.bfloat16) -> dict:
    """{part: fn() -> its output} for the `--split` modes, on seeded
    inputs on the model's device (module docstring)."""
    from gator_tpu_torch.nn.gat_trunk_train import (extract_block_params,
                                                    gat_trunk_train)
    from gator_tpu_torch.nn.lbf_stack_train import (ZERO_RATES,
                                                    extract_layer_params,
                                                    lbf_stack_train)
    from gator_tpu_torch.train.fused_forward import (gat_train_forward,
                                                     gat_trunk_fn,
                                                     mdr_train_forward)

    dev = next(model.parameters()).device
    gat, mdr = model.pose_lifter, model.pose2mesh
    j, c = gat.spec.num_joint, gat.spec.embed_dim
    nv, v = mdr.spec.coarse_num, mdr.spec.full_num
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def grad_of(fn, x, cot=None):
        x = x.detach().requires_grad_(True)
        y = fn(x)
        if cot is None:
            return torch.autograd.grad(y, x)[0]
        return torch.autograd.grad(y, x, cot)[0]

    parts = {}
    if "main" in modes:
        verts = randn(b, nv, 64, dtype=dtype)
        joints = randn(b, j, 64, dtype=dtype)
        vcot = randn(b, nv, 64, dtype=dtype)
        lps = [{k: t.detach() for k, t in extract_layer_params(mdr, i)
                .items()} for i in range(3)]

        def stack(x):
            return lbf_stack_train(x, joints, lps, mdr.spec.num_heads, 3)

        pose = randn(b, j, 2)
        trunk = gat_trunk_fn(gat.spec, 3)

        def lifter(p):
            p3, feat = gat_train_forward(gat, p, dtype, trunk)
            return (p3.float() ** 2).mean() + (feat.float() ** 2).mean()

        parts["K4 stack forward"] = lambda: stack(verts)
        parts["K4 stack forward and backward"] = lambda: grad_of(
            stack, verts, vcot)
        parts["GAT lifter forward and backward"] = lambda: grad_of(
            lifter, pose)
    if "losses" in modes:
        mesh = randn(b, v, 3, scale=0.1)
        gt = randn(b, v, 3, scale=0.1)
        lift = randn(b, j, 3, scale=100.0)
        reg = randn(b, 17, 3, scale=100.0)
        j_reg = torch.as_tensor(np.asarray(assets.j_regressor_h36m,
                                           np.float32), device=dev)

        def loss_of(m):
            return stage2_losses(m, gt, lift, reg, j_reg, assets.faces)

        tokens = randn(b, j, 5 + c, dtype=dtype)

        def head_of(xx):
            out, _ = mdr_train_forward(mdr, xx, 3, dtype, ZERO_RATES)
            return (out.float() ** 2).mean()

        parts["losses forward and backward"] = lambda: grad_of(loss_of,
                                                               mesh)
        parts["MDR forward and backward (rates 0)"] = lambda: grad_of(
            head_of, tokens)
    if "gat" in modes:
        feats = randn(b, j, c, dtype=dtype)
        fcot = randn(b, j, c, dtype=dtype)
        bias = gat.get_hop_path_encoding().detach().float()
        bps = [{k: t.detach() for k, t in extract_block_params(blk).items()}
               for blk in gat.blocks]

        def k5(xx):
            return gat_trunk_train(xx, bias, bps, gat.spec.masks_xfeat,
                                   gat.spec.num_heads, 3)

        parts["K5 trunk forward"] = lambda: k5(feats)
        parts["K5 trunk forward and backward"] = lambda: grad_of(k5, feats,
                                                                 fcot)
    return parts


def split_main(args) -> dict:
    """`--split`: each part of `split_parts` alone."""
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import GatorSpec, build_gator

    from .timing import measure
    cuda = args.device == "cuda"
    card = card_name() if cuda else None
    assets = build_assets("human36", data_dirs=[],
                          synthetic_vertex_num=args.vertex_num, seed=0)
    model = build_gator(GatorSpec.from_assets(assets, depth=args.depth),
                        seed=0, device=args.device)
    parts = split_parts(model, assets, args.batch, args.split)
    got = {}
    for name, fn in parts.items():
        with torch.set_grad_enabled(not name.endswith("forward")):
            got[name] = measure(fn, cuda)
    result = {"card": card, "device": args.device, "batch": args.batch,
              "dtype": "bfloat16", "modes": list(args.split),
              "vertex_num": args.vertex_num, "depth": args.depth,
              "parts": got}
    print(f"stage-2 step split, B={args.batch} bf16, on "
          f"{card or 'the CPU (host clock)'}, per call:")
    for name, p in got.items():
        dev = ("" if p["device_ms"] is None else
               f"{p['device_ms']:9.3f} ms device  {p['launches']:6.0f} "
               f"launches  idle {p['idle_share']:.3f}  ")
        print(f"  {p['host_ms']:9.3f} ms host  {dev}{name}")
    out = args.out or "build/profile_train_split.json"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", type=int, default=2, choices=(1, 2))
    ap.add_argument("--out", default=None,
                    help="default build/profile_train.json, with --split "
                         "build/profile_train_split.json")
    ap.add_argument("--split", nargs="+", choices=SPLIT_MODES,
                    help="time the step's parts alone (module docstring)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: --split only, host ms")
    ap.add_argument("--vertex_num", type=int, default=6890)
    ap.add_argument("--depth", type=int, default=6)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    if args.split:
        return split_main(args)
    if args.device != "cuda":
        raise SystemExit("profile_train: the step profile needs the card; "
                         "--device cpu takes --split only")
    from gator_tpu_torch import losses
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.train import (Adam, TrainState, make_gat_train_step,
                                       make_gator_train_step)

    dev = torch.device("cuda")
    dtype = torch.bfloat16
    card = card_name()
    assets = build_assets("human36", data_dirs=[],
                          synthetic_vertex_num=6890, seed=0)
    model = build_gator(GatorSpec.from_assets(assets), seed=11, device=dev)
    with torch.enable_grad():
        digests = kernel_digests(model)
    model.zero_grad(set_to_none=True)
    b, j = BATCH, model.spec.gat.num_joint
    v = model.spec.mdr.full_num
    rng = np.random.default_rng(1)
    if args.stage == 2:
        arrays = {"pose2d": rng.normal(size=(b, j, 2)),
                  "mesh": rng.normal(size=(b, v, 3)) * 0.1,
                  "lift_pose3d": rng.normal(size=(b, j, 3)) * 100,
                  "reg_pose3d": rng.normal(size=(b, 17, 3)) * 100,
                  "mesh_valid": np.ones((b, v, 1)),
                  "lift_valid": np.ones((b, j, 1)),
                  "reg_valid": np.ones((b, 17, 1))}
        state = TrainState(model, Adam(model.parameters(), lr=1e-4))
        step_fn = make_gator_train_step(
            model.spec, assets.faces, assets.j_regressor_h36m,
            losses.LossWeights(), dtype=dtype)
        extra = (7, 1.0)
    else:
        gat = model.pose_lifter
        arrays = {"pose2d": rng.normal(size=(b, j, 2)),
                  "joint_cam": rng.normal(0, 100, size=(b, j, 3)),
                  "joint_valid": np.ones((b, j, 1))}
        state = TrainState(gat, Adam(gat.parameters(), lr=1e-4))
        step_fn = make_gat_train_step(gat.spec, dtype=dtype)
        extra = (7,)
    batch = {k: torch.from_numpy(a.astype(np.float32)).to(dev)
             for k, a in arrays.items()}

    def step():
        return step_fn(state, batch, *extra)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir) as prof:
            for _ in range(STEPS):
                step()
        spans = read_spans(log_dir, STEPS)
    groups = collections.OrderedDict((label, 0.0) for _, label in GROUPS)
    plain = collections.Counter()
    for evt in prof.key_averages():
        if not _is_kernel(evt):
            continue
        us = _device_us(evt)
        for key, label in GROUPS:
            if key in evt.key:
                groups[label] += us
                break
        else:
            plain[evt.key[:90]] += us
    n = STEPS
    kernel_ms = {k: v / 1e3 / n for k, v in groups.items()}
    plain_ms = sum(plain.values()) / 1e3 / n
    busy = sum(kernel_ms.values()) + plain_ms
    window = spans["trace"]
    step_ms = window["host_ms"]
    result = {
        "card": card, "stage": args.stage, "batch": b, "dtype": "bfloat16",
        "joint_set": "human36",
        "host_step_ms_median": float(np.median(times)),
        "host_step_ms_all": times,
        "profiled_step_ms": step_ms,
        "device_ms_per_step": {**kernel_ms, "plain torch (all other kernels)":
                               plain_ms},
        "device_busy_ms_per_step": busy,
        # the union of device intervals over the profiled window
        "device_idle_share": window["idle_ms"] / window["host_ms"],
        # per step: host ms, launches, device ms, idle opened in the span
        "spans": {name: spans[name] for name in SPANS if name in spans},
        "plain_top": [(name, us / 1e3 / n)
                      for name, us in plain.most_common(12)],
        "kernel_digests": digests,
    }
    print(f"stage-{args.stage} step, B={b}, bf16, human36, "
          f"on {card}: {result['host_step_ms_median']:.3f} ms on the host "
          f"clock (median of {n}); profiled {step_ms:.3f} ms per step")
    for label, ms in result["device_ms_per_step"].items():
        print(f"  {ms:9.3f} ms  {100 * ms / step_ms:5.1f} %  {label}")
    print(f"  device busy {busy:.3f} ms per step, idle share "
          f"{result['device_idle_share']:.3f} of the profiled window")
    print("  per span of a step:")
    print("     host ms  launches  device ms    idle ms  span")
    for name, f in result["spans"].items():
        print(f"  {f['host_ms']:10.3f} {f['launches']:9.1f} "
              f"{f['device_ms']:10.3f} {f['idle_ms']:10.3f}  {name}")
    print(f"  K4/K5 digests: {sum(len(d) for d in digests.values())}")
    print("  largest plain-torch kernels:")
    for name, ms in result["plain_top"]:
        print(f"    {ms:8.3f} ms  {name}")
    out = args.out or "build/profile_train.json"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
