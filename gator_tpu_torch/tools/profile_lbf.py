"""The MDR LBF layer's kernels, timed and profiled on one CUDA device.

    python -m gator_tpu_torch.tools.profile_lbf

Builds the full-width synthetic human36 model (seeded random weights) and,
at B=2048 bf16 with 17 seeded random joint tokens, times K2
(`nn.lbf_stack`, 3 layers), K2-layer (`nn.lbf_layer`, one layer) and T1
`full` (`nn.run_layers`, 3 layers): the median of 5 runs of 3 calls by
CUDA events. Then the device time per launch of each of their kernels
under torch.profiler, the registers ptxas gave each kernel of K2 and
K2-layer (their build logs), and K2's plan on the card (keys per staged
K/V chunk of its self-attention, CTAs per SM of both launches, and the
rows kernel bf16 takes with its tile rows, shared bytes, registers and
warpgroups). K2's bf16 self-attention launch alone, over the three layers'
own rows output: the kernel the serving call takes
(csrc/lbf_selfattn_wg.cuh) beside csrc/lbf_stack.cu's two-pass kernel
through its uncounted C entry, by CUDA events, with the launch's three
floors a layer on an H100 (`selfattn_floors_ms`: its bytes at 3.35 TB/s,
its products at 989 TFLOP/s, its exponentials at ~3.9 T/s). For
scale only (the port never calls it), `scaled_dot_product_attention` on
the LBF self-attention's shapes over three layers (2 heads of 32 over the
431 vertices, bf16): at B=2048, beside K2's and T1's self-attention
launches, and at the train step's B=512 forward and forward plus
backward, beside K4's `lbf_sa_fwd` and `lbf_sa_bwd_dq` + `lbf_sa_bwd_dkv`.
Run it from two checkouts in one call to compare them on one card. `main`
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
from ..nn.lbf_stack import _SIGNATURE, stack_plan
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


def sdpa_ms(b: int, nv: int, layers: int = 3) -> dict:
    """`scaled_dot_product_attention` on [b, 2, nv, 32] bf16 q/k/v, a call
    per layer: forward ms and forward-plus-backward ms (CUDA events)."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(b, 2, nv, 32, generator=gen).to(
        "cuda", torch.bfloat16).requires_grad_(True) for _ in range(3))
    g = torch.randn(b, 2, nv, 32, generator=gen).to("cuda", torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd():
        with torch.no_grad():
            for _ in range(layers):
                sdpa(q, k, v)

    def fwd_bwd():
        for _ in range(layers):
            torch.autograd.grad(sdpa(q, k, v), (q, k, v), g)

    return {"forward": time_ms(fwd), "forward_backward": time_ms(fwd_bwd)}


def selfattn_floors_ms(b: int, nv: int, c: int = 64,
                       heads: int = 2) -> dict:
    """The least ms a layer of K2's self-attention launch can take on an
    H100, by each of its three limits: the bytes (q2/k2/v2 in bf16 and y3
    in, x' out in f32) at 3.35 TB/s; the products (QK and PV over every
    key, then L3) at 989 TFLOP/s in bf16; one exponential a score at the
    special-function units' ~3.9 T/s (FlashAttention-3's figure)."""
    d = c // heads
    fma = b * heads * nv * nv * d * 2 + b * nv * c * c
    return {"bytes": b * nv * c * (3 * 2 + 4 + 4) / 3.35e12 * 1e3,
            "products": 2 * fma / 989e12 * 1e3,
            "exponentials": b * heads * nv * nv / 3.9e12 * 1e3}


def selfattn_ms(verts: torch.Tensor, joints: torch.Tensor, stack) -> dict:
    """K2's bf16 self-attention launch alone over the three layers, ms a
    call (CUDA events): "lbf_selfattn_wg" through `lbf_selfattn_launch`
    (the kernel a bf16 serving call takes), "two_pass" through
    `lbf_selfattn_shared_launch`, each on the same per-layer rows output
    (the serving call's layers, the bf16 kernel's x' into the next)."""
    lib = cuda_lib.load("lbf_stack", _SIGNATURE)
    b, nv, _ = verts.shape
    stream = cuda_lib.stream_ptr(verts)
    offs = stack.offsets.data_ptr()
    x = verts.float()
    rows = []
    for layer in stack.flat:
        r = [torch.empty_like(x)] + [torch.empty_like(verts)
                                     for _ in range(3)]
        cuda_lib.check(lib.lbf_rows_launch(
            1, x.data_ptr(), joints.data_ptr(), layer.data_ptr(), offs,
            *(t.data_ptr() for t in r), b, nv, joints.shape[1], stream),
            "lbf_rows_launch")
        rows.append(r)
        x = torch.empty_like(x)
        cuda_lib.check(lib.lbf_selfattn_launch(
            1, *(t.data_ptr() for t in r[1:]), r[0].data_ptr(),
            layer.data_ptr(), offs, x.data_ptr(), b, nv, stream),
            "lbf_selfattn_launch")
    out = torch.empty_like(x)

    def run(entry):
        fn = getattr(lib, entry)
        for layer, (y3, q2, k2, v2) in zip(stack.flat, rows):
            cuda_lib.check(fn(1, q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
                              y3.data_ptr(), layer.data_ptr(), offs,
                              out.data_ptr(), b, nv, stream), entry)

    return {name: time_ms(lambda e=entry: run(e))
            for name, entry in (("lbf_selfattn_wg", "lbf_selfattn_launch"),
                                ("two_pass", "lbf_selfattn_shared_launch"))}


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
    sa = selfattn_ms(v, j, stack)
    floors = selfattn_floors_ms(BATCH, mdr.spec.coarse_num)
    print("K2 self-attention alone, 3 layers: " + ", ".join(
        f"{k} {t:.3f} ms ({t / 3:.3f} a layer)" for k, t in sa.items()))
    print("  its floors a layer: " + ", ".join(
        f"{k} {t:.3f} ms" for k, t in floors.items()))
    sdpa = {"B=2048": sdpa_ms(BATCH, mdr.spec.coarse_num),
            "B=512": sdpa_ms(512, mdr.spec.coarse_num)}
    print("for scale, scaled_dot_product_attention, 3 layers of [B, 2, "
          "431, 32] bf16: " + "; ".join(
              f"{b_}: forward {t['forward']:.3f} ms, forward and backward "
              f"{t['forward_backward']:.3f} ms" for b_, t in sdpa.items()))
    return {"card": card, "ms": ms, "kernel_ms": dict(kernels),
            "registers": regs, "plan": plan, "selfattn_ms": sa,
            "selfattn_floors_ms": floors, "sdpa_ms": sdpa}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
