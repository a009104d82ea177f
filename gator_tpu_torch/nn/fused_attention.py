"""K3: fused attention, softmax(q kᵀ·scale + bias) v without a probability
tensor in device memory.

`fused_attention` runs the hand-written CUDA kernels of
`csrc/fused_attention.cu` (products on the tensor cores: bf16 `mma`, or in
f32 the 3xTF32 split, which keeps f32 accuracy) on CUDA tensors and the
plain PyTorch version `fused_attention_ref` on CPU tensors. `route` picks
the kernel from Nq and Nk alone: up to `SHORT_TOKENS` queries and keys
the short-row kernel (a warp a (sample, head), persistent CTAs over whole
samples through a two-stage shared-memory ring, one pass with the row's
scores in registers; bound by the bytes of q, k, v and out), else the
tiled one (a CTA per 128-query tile, head and sample, K and V staged in
chunks sized so that two CTAs fit on an SM, two passes; bound by the
bytes at bf16, by the products in f32). Both give the same bits. They
replace gator_tpu/nn/pallas_attention.py:142 `fused_attention`; the plain
version is the counterpart of its `_xla_attention` (:104), rounding where
the TPU kernel rounds (scores and softmax in f32, the normalised
probabilities rounded to v's dtype before the PV product; in f32 the two
are the same function). As in the JAX package, the gradient is a plain
recompute (`_fused_bwd:122`): `FusedAttention` has the kernel forward and
a plain PyTorch backward.

In the model the module-form `attend` (nn/attention.py) routes here when
Nq·Nk ≥ 128² (the JAX package's own threshold, pallas_attention.py:160):
the MDR vertex self-attention, 431 x 431. MotionBERT's serving call
(models/motionbert.py) runs its spatial and temporal attentions here
through `fused_attention_into`, on strided views of its qkv product: the
temporal rows, (clip, joint) pairs, take the launch's second batch
dimension, and the output is written in the token layout the next product
reads. Those take the short-row kernel (16-17 tokens); the 431-key
calls (eval, the demo) the tiled one. HMR 2.0's serving call
(models/hmr2.py) runs its ViT-H backbone's 32 self-attentions (192 patch
tokens, 16 heads of 80) and its decoder's 6 cross-attentions (one query
against the 192 tokens, 8 heads of 64) on the tiled kernel, and the
decoder's 6 one-token self-attentions on the short-row one.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Tuple

import torch

from . import cuda_lib

HEAD_DIMS = (8, 16, 32, 64, 80)
# the most queries and keys of the short-row kernel: two m16 query tiles a
# warp, a row's scores in registers
SHORT_TOKENS = 32

_SIGNATURE = {
    "fused_attention_launch": [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 16
    + [ctypes.c_float, ctypes.c_void_p],
    "fused_attention_plan": [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
    "fused_attention_short_plan": [ctypes.c_int] * 7 + [ctypes.c_void_p],
}
# the short-row kernel takes the tiled kernel's arguments
_SIGNATURE["fused_attention_short_launch"] = _SIGNATURE[
    "fused_attention_launch"]


def route(nq: int, nk: int) -> str:
    """The kernel a launch of Nq queries against Nk keys takes: "short"
    (csrc/fused_attention.cu `attn_short::attention_kernel`) up to
    SHORT_TOKENS of each, else "tiled" (`attn::attention_kernel`)."""
    return "short" if nq <= SHORT_TOKENS and nk <= SHORT_TOKENS else "tiled"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor]) -> None:
    """Raises on what the kernel does not take: q [B, Nq, H, D] and k, v
    [B, Nk, H, D], or with two batch dimensions, q [B, B1, Nq, H, D] and
    k, v [B, B1, Nk, H, D]."""
    if q.dim() not in (4, 5) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError("fused_attention takes q [B, Nq, H, D] and k, v "
                         "[B, Nk, H, D] (or [B, B1, N, H, D])")
    lead = tuple(q.shape[:-3])
    nq, h, d = q.shape[-3:]
    nk = k.shape[-3]
    b = math.prod(lead)
    if k.shape != lead + (nk, h, d) or v.shape != k.shape:
        raise ValueError(f"fused_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"fused_attention kernel takes head widths "
                         f"{HEAD_DIMS}, not {d}")
    if nk < 1:
        raise ValueError("fused_attention: no keys")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype} must agree")
    cuda_lib.kernel_dtype(q.dtype)
    if k.device != q.device or v.device != q.device:
        raise ValueError("fused_attention: q, k and v must share a device")
    if b > 65535 or h > 65535:
        raise ValueError("fused_attention kernel takes at most 65535 "
                         "samples and heads")
    if bias is not None and (bias.shape != (h, nq, nk)
                             or bias.device != q.device):
        raise ValueError(f"fused_attention: bias {tuple(bias.shape)} "
                         f"must be [{h}, {nq}, {nk}] on q's device")


def attention_plan(nk: int, d: int, dtype: torch.dtype) -> Tuple[int, int]:
    """-> (keys per staged K/V chunk, CTAs resident per SM) of the kernel
    at `nk` keys on the current CUDA device, as csrc/fused_attention.cu
    plans its launch."""
    lib = cuda_lib.load("fused_attention", _SIGNATURE)
    kc, ctas = ctypes.c_int(), ctypes.c_int()
    cuda_lib.check(lib.fused_attention_plan(
        cuda_lib.kernel_dtype(dtype), d, nk, ctypes.byref(kc),
        ctypes.byref(ctas)), "fused_attention_plan")
    return kc.value, ctas.value


def short_plan(b: int, nq: int, nk: int, h: int, d: int,
               dtype: torch.dtype, b1: int = 1) -> dict:
    """The short-row kernel's plan for B x B1 samples on the current CUDA
    device: heads a unit (a sample's heads, or a group of them), units a
    ring stage, shared-memory bytes a CTA, CTAs resident an SM and CTAs
    launched."""
    lib = cuda_lib.load("fused_attention", _SIGNATURE)
    out = (ctypes.c_int * 5)()
    cuda_lib.check(lib.fused_attention_short_plan(
        cuda_lib.kernel_dtype(dtype), d, b, b1, nq, nk, h, out),
        "fused_attention_short_plan")
    return dict(zip(("heads_per_unit", "units_per_stage", "smem_bytes",
                     "ctas_per_sm", "ctas"), out))


def fused_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: q [B, Nq, H, D], k/v
    [B, Nk, H, D], bias [H, Nq, Nk] or None -> [B, Nq, H, D] in q's dtype."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias[None].float()
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether every [.., D] row of t starts on a 16-byte boundary with D
    contiguous, as the kernel's cp.async staging reads them."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:-1]))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], scale: float,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch csrc/fused_attention.cu on CUDA tensors, into `out` (any
    strides, D contiguous) or a fresh contiguous tensor; raises on what
    the kernel does not take. q [B, Nq, H, D] runs as [B, 1, Nq, H, D]."""
    _check(q, k, v, bias)
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    elif (out.shape != q.shape or out.dtype != q.dtype
          or out.device != q.device or out.stride(-1) != 1):
        raise ValueError(f"fused_attention: out {tuple(out.shape)} "
                         f"{out.dtype} must be q's shape and type on q's "
                         f"device with D contiguous")
    if q.dim() == 4:
        q, k, v, o5 = (t.unsqueeze(1) for t in (q, k, v, out))
    else:
        o5 = out
    b, b1, nq, h, d = q.shape
    nk = k.shape[2]
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    if b * b1 == 0 or nq == 0 or h == 0:
        return out
    short = route(nq, nk) == "short"
    # strided reads in the [B, B1, N, H, D] layout: D contiguous, and rows
    # on 16-byte boundaries for cp.async (the tiled kernel reads q by
    # element; else a fresh copy); the short kernel writes out in 16-byte
    # pieces too (else into a fresh tensor, then copied)
    q = q if (rows_aligned(q) if short else q.stride(-1) == 1) else \
        q.clone(memory_format=torch.contiguous_format)
    k, v = (t if rows_aligned(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (k, v))
    dst = o5 if not short or rows_aligned(o5) else torch.empty(
        o5.shape, dtype=o5.dtype, device=o5.device)
    lib = cuda_lib.load("fused_attention", _SIGNATURE)
    fn = (lib.fused_attention_short_launch if short
          else lib.fused_attention_launch)
    err = fn(cuda_lib.kernel_dtype(q.dtype), d, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), None if bias is None else bias.data_ptr(),
             dst.data_ptr(), b, b1, nq, nk, h, *q.stride()[:4],
             *k.stride()[:4], *v.stride()[:4], *dst.stride()[:4],
             float(scale), cuda_lib.stream_ptr(q))
    cuda_lib.check(err, "fused_attention_short_launch" if short
                   else "fused_attention_launch")
    if dst is not o5:
        o5.copy_(dst)
    fused_attention.launches += 1
    fused_attention.short_launches += short
    fused_attention.launches_by_dim[d] += 1
    fused_attention.short_launches_by_dim[d] += short
    return out


class FusedAttention(torch.autograd.Function):
    """The kernel forward (the plain version for CPU tensors) with the
    JAX package's plain recompute backward (pallas_attention.py:122-136):
    dq, dk, dv and dbias = ds summed over the batch."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias)
        if q.device.type == "cuda":
            return _launch(q, k, v, bias, scale)
        if q.device.type == "cpu":
            return fused_attention_ref(q, k, v, bias, scale)
        raise ValueError(f"fused_attention: unsupported device {q.device}")

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        scale = ctx.scale
        qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
        s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
        if bias is not None:
            s = s + bias[None].float()
        p = torch.softmax(s, dim=-1)
        dp = torch.einsum("bnhd,bmhd->bhnm", gf, vf)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
        dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
        dv = torch.einsum("bhnm,bnhd->bmhd", p, gf)
        dbias = None if bias is None else ds.sum(0).to(bias.dtype)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: float = 1.0) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (and nothing else: no fallback between
    the two). Differentiable in q, k, v and bias."""
    return FusedAttention.apply(q, k, v, bias, scale)


def fused_attention_into(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, out: Optional[torch.Tensor] = None,
                         use_kernel: bool = True) -> torch.Tensor:
    """softmax(q kᵀ·scale) v without a gradient (the serving path): q
    [B, Nq, H, D] or [B, B1, Nq, H, D], k and v alike, in any strides with
    D contiguous, written into `out` (q's shape, any strides with D
    contiguous) or a fresh contiguous tensor, which is returned. The CUDA
    kernels for CUDA tensors (counted in `fused_attention.launches`, and
    in `fused_attention.short_launches` on the short route; by head width
    in `launches_by_dim` and `short_launches_by_dim`), the plain
    version for CPU tensors or with `use_kernel=False`."""
    if use_kernel and q.device.type == "cuda":
        return _launch(q, k, v, None, scale, out)
    if use_kernel and q.device.type != "cpu":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    got = fused_attention_ref(*(t.reshape((-1,) + t.shape[-3:])
                                for t in (q, k, v)), None, scale)
    if out is None:
        return got.reshape(q.shape).contiguous()
    return out.copy_(got.reshape(q.shape))


# launches of the CUDA kernels (either route), and of the short-row kernel
# among them, in all and by head width D; the CPU path never counts
fused_attention.launches = 0
fused_attention.short_launches = 0
fused_attention.launches_by_dim = collections.Counter()
fused_attention.short_launches_by_dim = collections.Counter()
