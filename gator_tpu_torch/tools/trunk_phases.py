"""Where a CTA of K1 (csrc/gat_trunk.cu) spends its cycles, phase by phase.

    python -m gator_tpu_torch.tools.trunk_phases [--batches 1 256 2048]

Builds a copy of csrc/gat_trunk.cu (under build/kernels/phases/) in which
thread 0 of CTA 0 reads `clock64()` at the boundaries of each block's
phases, with a barrier added after each phase that does not end in one, and
runs it in bf16 on the full-width synthetic human36 trunk (depth 6, seeded
weights) at each batch, with the wrapper's samples per CTA. Prints the
cycles per block (the mean over the six blocks) of each phase: the
constants' staging, LN1 and the qkv product, the attention, the W1, proj
and W0 products, MGCN's mix, the x0 and x1 products, the hop-ring mix, the
back product, LN2, the MLP. The stamps and added barriers perturb the
kernel a little; the shares, not the sum, are the reading. The copy is made
by inserting the stamps at fixed lines of the kernel's source, so a change
there fails here at once. Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

PHASES = ("constants", "LN1 + qkv", "attention", "W1", "proj", "W0",
          "MGCN mix", "x0", "x1", "ring mix", "back", "LN2", "MLP")
# (line of the kernel's source, stamp inserted after it (True) or before)
STAMPS = (
    ("  for (int blk = 0; blk < nblk; ++blk) {\n", "    TS(0)\n", True),
    ("    __syncthreads();\n    auto kv2", "    TS(1)\n", False),
    ("    // o = softmax(q k^T / 4 + bias) v, per sample and head\n",
     "    TS(2)\n", True),
    ("      attention<T, C>(P, O, HB, R, rows, J);\n",
     "    __syncthreads(); TS(3)\n", True),
    ("    // ZF = attn = rounded o @ Wproj + b (over the dead k, v)\n",
     "    TS(4)\n", True),
    ("    // ZF += mdiag * g0 with g0 = y @ W0 (f32)\n", "    TS(5)\n", True),
    ("    // z = ZF + adj_off @ (M * g1) + b, rounded, per sample (over the "
     "dead\n", "    TS(6)\n", False),
    ("    // XFeat ring projections: f0p -> P[:, 0:C], f1p -> P[:, ZC:ZC+C2]"
     "\n", "    __syncthreads(); TS(7)\n", False),
    ("    product<T, C, P_X1>(ring, blk, mt, Y, L::LT,", "    TS(8)\n",
     False),
    ("    // ring sums over each sample's hop masks -> O[:, 0:CF] (o is dead)"
     "\n", "    TS(9)\n", False),
    ("    // x += [f0, f1] @ Wback + b\n", "    __syncthreads(); TS(10)\n",
     False),
    ("    // x += fc2(gelu(fc1(LN2(x)))): per chunk of HC hidden units, fc1's"
     "\n", "    TS(11)\n", False),
    ("    using RG = Ring<T, C>;\n",
     "    __syncthreads(); TS(12)\n", False),
    ("        emit(acc2[half], m0, n0, NP, half * NP, add);\n    }\n"
     "    __syncthreads();\n",
     "    TS(13)\n", True),
)
HEAD = ("namespace gator {\nnamespace trunk {\n",
        "__device__ long long g_ts[16 * 16];\n"
        "#define TS(k) if (blockIdx.x == 0 && tid == 0) "
        "g_ts[blk * 16 + (k)] = clock64();\n")
READ = ('\nextern "C" int read_stamps(long long* h) {\n'
        "  return (int)cudaMemcpyFromSymbol(h, gator::trunk::g_ts,\n"
        "                                   sizeof(gator::trunk::g_ts));\n"
        "}\n")


def stamped_source(src: str) -> str:
    """The kernel's source with the stamps inserted."""
    for line, stamp, after in (HEAD + (True,),) + STAMPS:
        if src.count(line) != 1:
            raise RuntimeError(f"trunk_phases: kernel line not found once: "
                               f"{line!r}")
        src = src.replace(line, line + stamp if after else stamp + line)
    return src + READ


def build() -> ctypes.CDLL:
    from ..nn import cuda_lib
    from ..nn.gat_trunk import _SIGNATURE
    out = os.path.join(cuda_lib.BUILD_DIR, "phases")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(cuda_lib.CSRC, "gat_trunk.cu")) as f:
        src = stamped_source(f.read())
    cu, lib = os.path.join(out, "gat_trunk_phases.cu"), os.path.join(
        out, "libgat_trunk_phases.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I",
                           cuda_lib.CSRC, "-o", lib, cu], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    dll = ctypes.CDLL(lib)
    dll.gat_trunk_launch.argtypes = _SIGNATURE["gat_trunk_launch"]
    dll.gat_trunk_launch.restype = ctypes.c_int
    dll.read_stamps.argtypes = [ctypes.c_void_p]
    return dll


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 256, 2048])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trunk_phases: no CUDA device")
    from ..assets import build_assets
    from ..models import GatorSpec, build_gator
    from ..nn import cuda_lib, fold_trunk_weights
    from ..nn.gat_trunk import launch_plan
    from .timing import card_name

    dll = build()
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                          seed=0)
    gat = build_gator(GatorSpec.from_assets(assets), seed=1,
                      device="cuda").pose_lifter
    j, nblk = gat.spec.num_joint, len(gat.blocks)
    bias = gat.get_hop_path_encoding().float().contiguous()
    masks = gat.blocks[0].x_feat.masks.float().contiguous()
    w = fold_trunk_weights(gat.blocks, torch.bfloat16, "cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    print(f"K1 phases, bf16, human36, cycles per block of CTA 0, on "
          f"{card_name()}")
    out = {}
    for b in args.batches:
        x = torch.from_numpy(rng.normal(size=(b, j, 128)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        y = torch.empty_like(x)
        g = launch_plan(b, j, torch.bfloat16, sms)["g"]
        for _ in range(3):
            cuda_lib.check(dll.gat_trunk_launch(
                1, 128, x.data_ptr(), bias.data_ptr(), masks.data_ptr(),
                w.flat.data_ptr(), w.offsets.data_ptr(), w.flat.shape[1],
                w.panels.data_ptr(), nblk, y.data_ptr(), b, j, g,
                cuda_lib.stream_ptr(x)), "gat_trunk_launch")
        torch.cuda.synchronize()
        ts = np.zeros(16 * 16, np.int64)
        cuda_lib.check(dll.read_stamps(ts.ctypes.data), "read_stamps")
        ts = ts.reshape(16, 16)[:nblk, :len(PHASES) + 1]
        cycles = dict(zip(PHASES, np.diff(ts, axis=1).mean(0).tolist()))
        out[b] = cycles
        print(f"  B={b} ({g} samples a CTA): "
              f"{(ts[:, -1] - ts[:, 0]).mean():.0f} a block: "
              + ", ".join(f"{k} {v:.0f}" for k, v in cycles.items()),
              flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
