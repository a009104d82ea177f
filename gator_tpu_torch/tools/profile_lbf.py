"""The MDR LBF layer's kernels, timed and profiled on one CUDA device.

    python -m gator_tpu_torch.tools.profile_lbf

Builds the full-width synthetic human36 model (seeded random weights) and,
at B=2048 bf16 with 17 seeded random joint tokens, times K2
(`nn.lbf_stack`, 3 layers), K2-layer (`nn.lbf_layer`, one layer) and T1
`full` (`nn.run_layers`, 3 layers): the median of 5 runs of 3 calls by
CUDA events. Then the device time per launch of each of their kernels
under torch.profiler, the registers ptxas gave each kernel of K2 and
K2-layer (their build logs), and K2's plan on the card (keys per staged
K/V chunk of its self-attention, CTAs per SM of both launches). Run it
from two checkouts in one call to compare them on one card. `main`
returns the numbers. Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import sys

import torch

from ..nn import (cuda_lib, extract_layer_params, fold_stack_weights,
                  lbf_layer, lbf_stack, run_layers)
from ..nn.lbf_stack import stack_plan
from .profile_train import _device_us, _is_kernel
from .timing import card_name, time_ms

BATCH = 2048
LIBS = ("lbf_stack", "lbf_layer", "lbf_ablate")
# T1's library holds every mode's kernels; its `full` pair is K2-layer's
# code under T1's rounding, so the report lists the other two
REPORTED = ("lbf_stack", "lbf_layer")


def registers(lib: str) -> dict:
    """{kernel (mangled): registers} from the ptxas report of lib`lib`."""
    out, name = {}, None
    with open(os.path.join(cuda_lib.BUILD_DIR, f"lib{lib}.log")) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name], name = int(m.group(1)), None
    return out


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_lbf: no CUDA device")
    from ..assets import build_assets
    from ..models import GatorSpec, build_gator

    card = card_name()
    for lib in LIBS:
        cuda_lib.build(lib)
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=6890,
                          seed=0)
    mdr = build_gator(GatorSpec.from_assets(assets, embed_dim=128, depth=6,
                                            alpha=False), seed=0,
                      device="cuda").pose2mesh
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    verts = torch.randn(BATCH, mdr.spec.coarse_num, 64, generator=gen)
    joints = torch.randn(BATCH, 17, 64, generator=gen)
    v, j = verts.to("cuda", bf16), joints.to("cuda", bf16)
    stack = fold_stack_weights(mdr, bf16, "cuda")
    layers = [extract_layer_params(mdr, i, bf16, "cuda") for i in range(3)]
    calls = {
        "K2": lambda: lbf_stack(v, j, stack, 2),
        "K2-layer": lambda: lbf_layer(v, j, layers[0], 2),
        "T1 full": lambda: run_layers(v, j, layers, 2, 8, "full"),
    }
    with torch.no_grad():
        ms = {name: time_ms(fn) for name, fn in calls.items()}
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts,
                                    acc_events=True) as prof:
            for fn in calls.values():
                fn()
            torch.cuda.synchronize()
    kernels = collections.OrderedDict(
        (e.key, _device_us(e) / e.count / 1e3)
        for e in prof.key_averages() if _is_kernel(e))
    regs = {lib: registers(lib) for lib in REPORTED}
    plan = stack_plan(bf16, mdr.spec.coarse_num)
    print(f"B={BATCH} bf16, 431 vertices, 17 joints, on {card}")
    for name, t in ms.items():
        print(f"  {name:10s} {t:8.3f} ms")
    print("device ms per launch:")
    for name, t in kernels.items():
        print(f"  {t:8.3f}  {name[:90]}")
    print("registers:")
    for lib, kerns in regs.items():
        for name, n in kerns.items():
            print(f"  {n:4d}  {lib}: {name}")
    print(f"K2 plan: {plan}")
    return {"card": card, "ms": ms, "kernel_ms": dict(kernels),
            "registers": regs, "plan": plan}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
