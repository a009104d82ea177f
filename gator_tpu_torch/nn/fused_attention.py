"""K3: fused attention, softmax(q kᵀ·scale + bias) v without a probability
tensor in device memory.

`fused_attention` runs the hand-written CUDA kernel of
`csrc/fused_attention.cu` (products on the tensor cores: bf16 `mma`, or in
f32 the 3xTF32 split, which keeps f32 accuracy; K and V staged in shared
memory in their own dtype, in chunks the kernel sizes so that two CTAs
fit on an SM) on CUDA tensors and the
plain PyTorch version `fused_attention_ref` on CPU tensors. It replaces
gator_tpu/nn/pallas_attention.py:142 `fused_attention`; the plain version
is the counterpart of its `_xla_attention` (:104), rounding where the TPU
kernel rounds (scores and softmax in f32, the normalised probabilities
rounded to v's dtype before the PV product; in f32 the two are the same
function). As in the JAX package, the gradient is a plain recompute
(`_fused_bwd:122`): `FusedAttention` has the kernel forward and a plain
PyTorch backward.

In the model the module-form `attend` (nn/attention.py) routes here when
Nq·Nk ≥ 128² (the JAX package's own threshold, pallas_attention.py:160):
the MDR vertex self-attention, 431 x 431.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_lib

HEAD_DIMS = (8, 16, 32, 64)

_SIGNATURE = {
    "fused_attention_launch": [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_void_p],
    "fused_attention_plan": [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor]) -> None:
    """Raises on what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("fused_attention takes q [B, Nq, H, D] and k, v "
                         "[B, Nk, H, D]")
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if k.shape != (b, nk, h, d) or v.shape != k.shape:
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
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:3]))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Launch csrc/fused_attention.cu on CUDA tensors; raises on what the
    kernel does not take."""
    _check(q, k, v, bias)
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or nq == 0 or h == 0:
        return out
    # strided reads in the [B, N, H, D] layout: D contiguous, and k and v
    # rows on 16-byte boundaries for cp.async (else a fresh copy)
    q = q if q.stride(3) == 1 else q.contiguous()
    k, v = (t if rows_aligned(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (k, v))
    lib = cuda_lib.load("fused_attention", _SIGNATURE)
    err = lib.fused_attention_launch(
        cuda_lib.kernel_dtype(q.dtype), d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), b, nq, nk, h, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale), cuda_lib.stream_ptr(q))
    cuda_lib.check(err, "fused_attention_launch")
    fused_attention.launches += 1
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


# launches of the CUDA kernel; the CPU path never counts
fused_attention.launches = 0
