"""Per-stage serving profile on one CUDA device.

    PROF_BATCH=2048 python -m gator_tpu_torch.tools.profile_serving

The counterpart of tools/profile_serving.py. Builds the full-width
synthetic human36 model (6890/431 vertices, embed 128, depth 6, alpha
False, seeded random weights) and times, in bf16 at batch PROF_BATCH
(default 2048), on seeded random inputs:
  gat total      `gat_serving_forward` (embeds, K1 trunk, lifter head);
  gat trunk      K1 (`nn.gat_trunk`) alone on a [B, J, 128] input;
  mdr total      `mdr_serving_forward` from a [B, J, 133] input (K2);
  lbf layers     three K2-layer calls (`nn.lbf_layer`), one per layer;
  lbf v3 stack   K2 (`nn.lbf_stack`) on the same verts and joints;
  head+embeds    mdr total minus lbf layers, as the JAX tool computes it
                 (below zero where three K2-layer calls take longer than
                 the K2 call inside mdr total);
  full serving   the whole `make_serving_fn` call.
Each time is the median of 5 runs of 3 calls, by CUDA events. Then, from
one profiled window of 5 whole serving calls (CPU and CUDA activity,
`timing.span_profile`), for the call's span `serve` and each of its
stages (serve.gat_embed, serve.k1, serve.gat_head, serve.mdr_tokens,
serve.k2, serve.head, serve.upsample): host ms, kernel launches, device
ms and the device idle that opens inside it, per call. Prints the card's
name and power limit, the JAX tool's lines and the stages; `main` returns
the numbers. Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .. import serving
from ..nn import extract_layer_params, lbf_layer, lbf_stack
from .timing import card_name, span_profile, time_ms

DTYPE = torch.bfloat16
STAGES = ("serve.gat_embed", "serve.k1", "serve.gat_head",
          "serve.mdr_tokens", "serve.k2", "serve.head", "serve.upsample",
          "serve")


def make_stages(model, dtype: torch.dtype, batch: int, seed: int = 0
                ) -> Dict[str, Tuple[Callable, tuple]]:
    """-> {stage: (fn, args)} on the model's device, with seeded normal
    inputs of batch `batch` (the pose in f32, the rest in `dtype`)."""
    spec = model.spec
    dev = next(model.parameters()).device
    j, heads = spec.gat.num_joint, spec.mdr.num_heads
    w, consts = serving.serving_weights(model, dtype)
    layers = [extract_layer_params(model.pose2mesh, i, dtype, dev)
              for i in range(len(model.pose2mesh.lbf_layers()))]
    rng = np.random.default_rng(seed)

    def normal(*shape, dt=dtype):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device=dev, dtype=dt)

    pose = normal(batch, j, 2, dt=torch.float32)
    x = normal(batch, j, 5 + spec.gat.embed_dim)     # [2d, 3d, features]
    verts = normal(batch, spec.mdr.coarse_num, spec.mdr.embed_dim)
    joints = normal(batch, j, spec.mdr.embed_dim)
    tokens = normal(batch, j, spec.gat.embed_dim)   # K1's input, drawn last

    def lbf_layers(v, jt, layers):
        for lw in layers:
            v = lbf_layer(v, jt, lw, heads)
        return v

    return {
        "gat total": (lambda p: serving.gat_serving_forward(
            model, w, consts, p, dtype), (pose,)),
        "gat trunk": (lambda t: consts["trunk_fn"](
            t, consts["hop_bias"], consts["masks"], consts["trunk"],
            spec.gat.num_heads), (tokens,)),
        "mdr total": (lambda xx: serving.mdr_serving_forward(
            model, w, consts, xx, dtype), (x,)),
        "lbf layers": (lbf_layers, (verts, joints, layers)),
        "lbf v3 stack": (lambda v, jt: lbf_stack(v, jt, consts["stack"],
                                                 heads), (verts, joints)),
        "full serving": (serving.make_serving_fn(model, dtype), (pose,)),
    }


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    b = int(os.environ.get("PROF_BATCH", "2048"))
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device")
    from ..assets import build_assets
    from ..models import GatorSpec, build_gator

    card = card_name()
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=6890,
                          seed=0)
    model = build_gator(GatorSpec.from_assets(assets, embed_dim=128, depth=6,
                                              alpha=False), seed=0,
                        device="cuda")
    stages = make_stages(model, DTYPE, b)
    with torch.no_grad():
        ms = {name: time_ms(lambda fn=fn, a=a: fn(*a))
              for name, (fn, a) in stages.items()}
        fn, a = stages["full serving"]
        spans = span_profile(lambda: fn(*a), 5)
    ms["head+embeds"] = ms["mdr total"] - ms["lbf layers"]
    print(f"batch {b}, bf16, on {card}")
    print(f"  gat total      {ms['gat total']:8.3f} ms")
    print(f"    gat trunk    {ms['gat trunk']:8.3f} ms")
    print(f"  mdr total      {ms['mdr total']:8.3f} ms")
    print(f"    lbf layers   {ms['lbf layers']:8.3f} ms")
    print(f"    lbf v3 stack {ms['lbf v3 stack']:8.3f} ms")
    print(f"    head+embeds  {ms['head+embeds']:8.3f} ms")
    print(f"  full serving   {ms['full serving']:8.3f} ms "
          f"({b / ms['full serving'] * 1e3:,.0f} poses/s)")
    print("  per stage of a serving call (one profiled window of 5 calls):")
    print("     host ms  launches  device ms    idle ms  span")
    for name in STAGES:
        f = spans[name]
        print(f"  {f['host_ms']:10.3f} {f['launches']:9.1f} "
              f"{f['device_ms']:10.3f} {f['idle_ms']:10.3f}  {name}")
    sys.stdout.flush()
    return {"card": card, "batch": b, "dtype": "bfloat16", "ms": ms,
            "stages": {name: spans[name] for name in STAGES}}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
