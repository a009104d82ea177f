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

Then K3 as MotionBERT's serving call launches it, on the short-row kernel
(`clip_modes`: 128 clips of 16 frames of 17 joints, 8 heads of 64, bf16,
on views of one qkv product): the spatial mode, [2048 frames, 17, 8, 64],
and the temporal mode, [128 clips, 17 joints, 16, 8, 64] written through a
permuted view, each beside its bound: q, k, v and out, 142.6 MB, at 3.35
TB/s.

Then K3 as HMR 2.0's serving call launches it (`vit_modes`: the ViT-H
backbone's self-attention, 64 crops of 192 patch tokens, 16 heads of 80,
and the decoder's cross-attention, one query against the 192 tokens, 8
heads of 64; bf16, on views of one qkv or kv product), each beside its
bytes bound (q, k, v and out at 3.35 TB/s, the widths read by
benchmark/core/hmr2_counts.py from the cell's configuration, run from the
checkout's root) and, for scale (not on the path), PyTorch's
scaled_dot_product_attention on the same shapes.

Last, sha256 digests of K3's outputs (`digests`) at both MotionBERT modes
and at the eval shape with and without a bias, bf16 and f32, and at every
head width up to 64 on both kernels (`head_width_digests`), on seeded
inputs, through the public entry points only: the same tool run in an
older checkout gives that tree's, so that two trees' K3 can be compared
bit for bit in one call.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import re
import sys

import torch
import torch.nn.functional as F

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


def vit_modes(crops: int = 64) -> dict:
    """{mode: {"ms", "bound_ms", "sdpa_ms"}} of K3's launches in HMR 2.0's
    serving call (module docstring)."""
    from benchmark.core import hmr2_counts, spec
    d = hmr2_counts.dims(spec.config("hmr2-vith16-256x192"))
    n, c, h = d["n"], d["c"], d["heads"]
    hd, dh = d["inner"] // d["dim_head"], d["dim_head"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = torch.randn(crops, n, 3, h, c // h, generator=gen,
                          device="cuda").bfloat16().unbind(2)
    tok = torch.randn(crops, 1, hd, dh, generator=gen,
                      device="cuda").bfloat16()
    kv = torch.randn(crops, n, 2, hd, dh, generator=gen,
                     device="cuda").bfloat16()
    nbytes = hmr2_counts.k3_launch_bytes(d, crops)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in (q, k, v)))

    with torch.no_grad():
        return {
            "vit": {"ms": time_ms(lambda: fused_attention_into(
                q, k, v, (c // h) ** -0.5)),
                "bound_ms": nbytes["vit"] / 3.35e12 * 1e3,
                "sdpa_ms": time_ms(lambda: sdpa(q, k, v))},
            "cross": {"ms": time_ms(lambda: fused_attention_into(
                tok, kv[:, :, 0], kv[:, :, 1], dh ** -0.5)),
                "bound_ms": nbytes["cross"] / 3.35e12 * 1e3,
                "sdpa_ms": time_ms(lambda: sdpa(tok, kv[:, :, 0],
                                                kv[:, :, 1]))}}


def head_width_digests() -> dict:
    """{case: sha256[:16] of K3's output} at head widths 8, 16, 32 and 64,
    bf16 and f32: the tiled kernel at 192 x 192 tokens and at one query
    against 192 keys (B = 8, 4 heads), the short-row kernel at 17 x 17
    (B = 64, 8 heads), on seeded inputs."""
    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()[:16]

    gen = torch.Generator(device="cuda").manual_seed(80)
    out = {}
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            for d in (8, 16, 32, 64):
                for name, b, nq, nk, h in (("tiled", 8, 192, 192, 4),
                                           ("tiled_q1", 8, 1, 192, 4),
                                           ("short", 64, 17, 17, 8)):
                    q = torch.randn(b, nq, h, d, generator=gen,
                                    device="cuda").to(dt)
                    k, v = (torch.randn(b, nk, h, d, generator=gen,
                                        device="cuda").to(dt)
                            for _ in range(2))
                    out[f"{name}_d{d}_{str(dt)[6:]}"] = digest(
                        fused_attention_into(q, k, v, d ** -0.5))
    return out


def digests() -> dict:
    """{case: sha256[:16] of K3's output} (module docstring): the
    spatial and temporal launches of 128 clips x 16 frames x 17 joints, 8
    heads of 64, on views of one qkv product, the temporal one written
    through a permuted view; the eval shape (B=512, 431 x 431, 2 heads of
    32) with and without a bias."""
    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()[:16]

    gen = torch.Generator(device="cuda").manual_seed(2022)
    out = {}
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt)[6:]
            q, k, v = torch.randn(128, 16, 17, 3, 8, 64, generator=gen,
                                  device="cuda").to(dt).unbind(3)
            out[f"spatial_{name}"] = digest(fused_attention_into(
                *(z.reshape(2048, 17, 8, 64) for z in (q, k, v)), 0.125))
            buf = torch.empty(128, 16, 17, 8, 64, dtype=dt, device="cuda")
            fused_attention_into(
                *(z.permute(0, 2, 1, 3, 4) for z in (q, k, v)), 0.125,
                buf.permute(0, 2, 1, 3, 4))
            out[f"temporal_{name}"] = digest(buf)
            q, k, v = (torch.randn(512, 431, 2, 32, generator=gen,
                                   device="cuda").to(dt) for _ in range(3))
            bias = torch.randn(2, 431, 431, generator=gen, device="cuda")
            out[f"eval_{name}"] = digest(fused_attention(q, k, v, None,
                                                         0.17))
            out[f"eval_bias_{name}"] = digest(fused_attention(q, k, v, bias,
                                                              0.17))
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
    clip = clip_modes()
    vit = vit_modes()
    bits = dict(digests(), **head_width_digests())
    regs = ptxas_report("fused_attention")
    print(f"K3 on {card}")
    for name, r in rows.items():
        print(f"  {name:32s} {r['ms']:8.4f} ms  err {r['max_abs_err']:.3e}"
              f"  chunk {r['chunk_keys']} keys, {r['ctas_per_sm']} CTAs/SM")
    for mode, r in clip.items():
        print(f"  MotionBERT {mode:21s} {r['ms']:8.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms (bytes)")
    for mode, r in vit.items():
        print(f"  HMR 2.0 {mode:24s} {r['ms']:8.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms (bytes)  SDPA {r['sdpa_ms']:.4f} ms")
    print("registers (spill store bytes):")
    for name, (n, spill) in regs.items():
        print(f"  {n:4d} ({spill})  {name}")
    print("output digests (sha256[:16]):")
    for name, d in bits.items():
        print(f"  {name:20s} {d}")
    return {"card": card, "shapes": rows, "clip_modes": clip,
            "vit_modes": vit, "registers": regs, "digests": bits}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
