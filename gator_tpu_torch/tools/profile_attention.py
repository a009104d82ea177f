"""K3 (`nn.fused_attention`) timed on one CUDA device, with its launch plan.

    python -m gator_tpu_torch.tools.profile_attention

At the eval path's shape (B=512, 431 x 431, 2 heads of 32) and at head
width 64 (B=512 at 431 keys; B=64 at 1000 keys, where K and V are staged in
chunks), in f32 and bf16, on seeded random inputs: the kernel's time (the
median of 5 runs of 3 calls by CUDA events), its max abs difference from
the plain version, and its plan (keys per staged K/V chunk, CTAs resident
per SM); then the registers and spills ptxas gave each instantiation (the
build log). Run it from two checkouts in one call to compare them on one
card. `main` returns the numbers. Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import re
import sys

import torch

from ..nn import cuda_lib
from ..nn.fused_attention import (attention_plan, fused_attention,
                                  fused_attention_ref)
from .timing import card_name, time_ms

# (B, N, H, D): queries and keys alike
SHAPES = ((512, 431, 2, 32), (512, 431, 2, 64), (64, 1000, 2, 64))


def ptxas_report(lib: str) -> dict:
    """{kernel (mangled): (registers, spill store bytes)} from the ptxas
    report of lib`lib`."""
    out, name, spill = {}, None, 0
    with open(os.path.join(cuda_lib.BUILD_DIR, f"lib{lib}.log")) as f:
        for line in f:
            m = re.search(r"Function properties for (\w+)", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name], name = (int(m.group(1)), spill), None
    return out


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention: no CUDA device")
    card = card_name()
    gen = torch.Generator().manual_seed(0)
    rows = {}
    for b, n, h, d in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, n, h, d, generator=gen).to("cuda",
                                                                 dtype)
                       for _ in range(3))
            scale = d ** -0.5
            with torch.no_grad():
                err = (fused_attention(q, k, v, None, scale).float()
                       - fused_attention_ref(q, k, v, None, scale).float()
                       ).abs().max().item()
                ms = time_ms(lambda: fused_attention(q, k, v, None, scale))
            kc, ctas = attention_plan(n, d, dtype)
            rows[f"B={b} {n}x{n} H={h} D={d} {str(dtype)[6:]}"] = {
                "ms": ms, "max_abs_err": err, "chunk_keys": kc,
                "ctas_per_sm": ctas}
    regs = ptxas_report("fused_attention")
    print(f"K3 on {card}")
    for name, r in rows.items():
        print(f"  {name:32s} {r['ms']:8.4f} ms  err {r['max_abs_err']:.3e}"
              f"  chunk {r['chunk_keys']} keys, {r['ctas_per_sm']} CTAs/SM")
    print("registers (spill store bytes):")
    for name, (n, spill) in regs.items():
        print(f"  {n:4d} ({spill})  {name}")
    return {"card": card, "shapes": rows, "registers": regs}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
