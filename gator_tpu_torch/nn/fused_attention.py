"""K3: fused attention, softmax(q kᵀ·scale + bias) v without a probability
tensor in device memory.

`fused_attention` runs the hand-written CUDA kernel of
`csrc/fused_attention.cu` on CUDA tensors and the plain PyTorch version
`fused_attention_ref` on CPU tensors. It replaces
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
from typing import Optional

import torch

from . import cuda_lib

HEAD_DIMS = (8, 16, 32, 64)
# shared memory a CTA may use on an H100 (sm_90), where the device does not
# report it
_SMEM_OPTIN_H100 = 232_448

_SIGNATURE = {
    "fused_attention_launch": [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_void_p],
    "fused_attention_rows": [ctypes.c_int] * 4,
}


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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Launch csrc/fused_attention.cu on CUDA tensors; raises on what the
    kernel does not take."""
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
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype} must agree")
    code = cuda_lib.kernel_dtype(q.dtype)
    if k.device != q.device or v.device != q.device:
        raise ValueError("fused_attention: q, k and v must share a device")
    if nk == 0:
        raise ValueError("fused_attention: no keys")
    if b > 65535 or h > 65535:
        raise ValueError("fused_attention kernel takes at most 65535 "
                         "samples and heads")
    if bias is not None:
        if bias.shape != (h, nq, nk) or bias.device != q.device:
            raise ValueError(f"fused_attention: bias {tuple(bias.shape)} "
                             f"must be [{h}, {nq}, {nk}] on q's device")
        bias = bias.to(torch.float32).contiguous()
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or nq == 0 or h == 0:
        return out
    # strided reads in the [B, N, H, D] layout; only D must be contiguous
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    lib = cuda_lib.load("fused_attention", _SIGNATURE)
    smem = getattr(torch.cuda.get_device_properties(q.device),
                   "shared_memory_per_block_optin", _SMEM_OPTIN_H100)
    rows = lib.fused_attention_rows(nq, nk, d, smem)
    if rows < 1:
        raise ValueError(f"fused_attention: one score row of {nk} keys "
                         f"does not fit in {smem} bytes of shared memory")
    err = lib.fused_attention_launch(
        code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        b, nq, nk, h, rows, *q.stride()[:3], *k.stride()[:3],
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
