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

Then K3 as MotionBERT's serving call launches it (`clip_modes`: 128 clips
of 16 frames of 17 joints, 8 heads of 64, bf16, on views of one qkv
product): the spatial mode, [2048 frames, 17, 8, 64], and the temporal
mode, [128 clips, 17 joints, 16, 8, 64] written through a permuted view,
each beside its bound: q, k, v and out, 142.6 MB, at 3.35 TB/s.
"""
from __future__ import annotations

import argparse
import os
import re
import sys

import torch

from ..nn import cuda_lib
from ..nn.fused_attention import (attention_plan, fused_attention,
                                  fused_attention_into, fused_attention_ref)
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


def clip_modes(clips: int = 128, t: int = 16, j: int = 17) -> dict:
    """{mode: {"ms", "bound_ms"}} of K3's two launches in MotionBERT's
    serving call (module docstring)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(clips, t, j, 3, 8, 64, generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv.unbind(3)
    spatial = [z.view(clips * t, j, 8, 64) for z in (q, k, v)]
    temporal = [z.permute(0, 2, 1, 3, 4) for z in (q, k, v)]
    out = torch.empty(clips, t, j, 8, 64, dtype=torch.bfloat16,
                      device="cuda").permute(0, 2, 1, 3, 4)
    bound = 4 * q.numel() * 2 / 3.35e12 * 1e3
    with torch.no_grad():
        return {
            "spatial": {"ms": time_ms(lambda: fused_attention_into(
                *spatial, 0.125)), "bound_ms": bound},
            "temporal": {"ms": time_ms(lambda: fused_attention_into(
                *temporal, 0.125, out)), "bound_ms": bound}}


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
    clip = clip_modes()
    regs = ptxas_report("fused_attention")
    print(f"K3 on {card}")
    for name, r in rows.items():
        print(f"  {name:32s} {r['ms']:8.4f} ms  err {r['max_abs_err']:.3e}"
              f"  chunk {r['chunk_keys']} keys, {r['ctas_per_sm']} CTAs/SM")
    for mode, r in clip.items():
        print(f"  MotionBERT {mode:21s} {r['ms']:8.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms (bytes)")
    print("registers (spill store bytes):")
    for name, (n, spill) in regs.items():
        print(f"  {n:4d} ({spill})  {name}")
    return {"card": card, "shapes": rows, "clip_modes": clip,
            "registers": regs}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
