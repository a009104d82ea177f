"""K2-layer: one MDR LBF layer with unfolded weights, rounding as the
serving layer kernel rounds (inference only).

`lbf_layer` runs the hand-written CUDA kernels of `csrc/lbf_layer.cu` on a
CUDA tensor and the plain PyTorch version `lbf_layer_ref` on a CPU tensor.
It replaces gator_tpu/nn/pallas_mdr.py:153 `lbf_layer_fused`, whose body is
`_layer_math:87`: unlike K2 (`lbf_stack`), it rounds to the working dtype
after every product and every bias add, rounds the normalised attention
probabilities, keeps the self-attention residual on the rounded std-LN
output, and returns the layer's output in the working dtype.

This module also owns the packing of one layer's weights
(`extract_layer_params`), which K2's `fold_stack_weights` and T1
(`lbf_ablate`) build on.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from . import cuda_lib
from .layers import layer_norm32, std_layer_norm
from .lbf_stack_train import extract_layer_params as layer_tensors

# Field order of one layer's packed weights; must match `enum Field` in
# csrc/lbf_layer.cuh (which csrc/lbf_stack.cu includes). Matrices are
# [in, out].
STACK_FIELDS = (
    "ln1_w", "ln1_b", "wq", "wk", "wv", "proj_w", "proj_b",
    "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "a2", "b2",
    "l0_w", "l0_b", "l1_w", "l1_b", "l2_w", "l2_b", "l3_w", "l3_b",
)
# the JAX package's names (pallas_mdr.py:35 LAYER_PARAM_KEYS) that differ
# from the field names; every other key is a field name
FIELD_OF_KEY = {"norm1_scale": "ln1_w", "norm1_bias": "ln1_b",
                "norm2_scale": "ln2_w", "norm2_bias": "ln2_b"}

EMBED, HEADS, JOINTS_MAX = 64, 2, 32

_SIGNATURE = {
    "lbf_layer_rows_launch": [ctypes.c_int] + [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "lbf_layer_attn_launch": [ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "lbf_layer_attn_info": [ctypes.c_int] * 3,
}
# what the attention launch's plan reports, by its index in `attn_info`
ATTN_INFO = ("chunk_keys", "ctas_per_sm", "smem_bytes", "registers")


def pack_layer(params: Dict[str, torch.Tensor], dtype: torch.dtype,
               device) -> cuda_lib.Packed:
    """One layer's tensors, named as `LAYER_PARAM_KEYS` (linear weights
    [in, out]), packed in `STACK_FIELDS` order for the kernels."""
    fields = {FIELD_OF_KEY.get(k, k): v for k, v in params.items()}
    return cuda_lib.pack([fields], STACK_FIELDS, dtype, device)


def extract_layer_params(mdr, layer: int, dtype: torch.dtype,
                         device) -> cuda_lib.Packed:
    """Layer `layer` of an `MDR` module packed for the kernels
    (gator_tpu/nn/pallas_mdr.py:455 `extract_layer_params`)."""
    with torch.no_grad():
        return pack_layer(layer_tensors(mdr, layer), dtype, device)


def lbf_layer_ref(verts: torch.Tensor, joints: torch.Tensor,
                  weights: cuda_lib.Packed, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: verts [B, Nv, C], joints [B, J, C] in the
    dtype of `weights`, rounding where `_layer_math` rounds; every product
    accumulates in f32. -> [B, Nv, C] in that dtype."""
    dt = weights.dtype

    def rnd(t):
        return t.to(dt).float()

    def heads(t):
        b, n, c = t.shape
        return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)

    def attend(q, k, v):
        prob = rnd(torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1))
        o = prob @ v                                   # [B, H, N, D]
        return rnd(o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1))

    def linear(t, name):
        return rnd(rnd(t @ p[name + "_w"]) + p[name + "_b"])

    (p,) = [{k: v.float() for k, v in w.items()} for w in weights.layers]
    scale = (verts.shape[-1] // num_heads) ** -0.5
    x = verts.float()
    yv = rnd(layer_norm32(x, p["ln1_w"], p["ln1_b"]))
    yj = rnd(layer_norm32(joints.float(), p["ln1_w"], p["ln1_b"]))
    o = attend(heads(rnd(yv @ p["wq"])), heads(rnd(yj @ p["wk"])),
               heads(rnd(yj @ p["wv"])))
    x1 = x + linear(o, "proj")
    y2 = rnd(layer_norm32(x1, p["ln2_w"], p["ln2_b"]))
    m = rnd(F.gelu(linear(y2, "fc1")))
    x2 = x1 + linear(m, "fc2")
    y3 = rnd(std_layer_norm(x2, p["a2"], p["b2"]))
    o = attend(*(heads(linear(y3, f"l{i}")) for i in range(3)))
    return (y3 + linear(o, "l3")).to(dt)


def check_layer_args(what: str, verts: torch.Tensor, joints: torch.Tensor,
                     weights: cuda_lib.Packed) -> None:
    """Raise on what the layer kernels (K2-layer, T1) do not take."""
    b, nv, c = verts.shape
    nj = joints.shape[1]
    if c != EMBED or joints.shape != (b, nj, c) or not 1 <= nj <= JOINTS_MAX:
        raise ValueError(f"{what} kernels take C={EMBED} and 1..{JOINTS_MAX}"
                         f" joints: verts {tuple(verts.shape)}, joints "
                         f"{tuple(joints.shape)}")
    if not verts.dtype == joints.dtype == weights.dtype:
        raise TypeError(f"verts {verts.dtype}, joints {joints.dtype}, "
                        f"weights {weights.dtype} must agree")
    if weights.flat.shape[0] != 1:
        raise ValueError(f"{what} takes one layer's packed weights, not "
                         f"{weights.flat.shape[0]}")
    for t in (joints, weights.flat, weights.offsets):
        if t.device != verts.device:
            raise ValueError(f"{what}: all tensors must be on verts' device")


def attn_info(dtype: torch.dtype, nv: int) -> Dict[str, int]:
    """The self-attention launch's plan at `nv` vertices on the current
    card: keys per staged K/V chunk, CTAs resident per SM, shared-memory
    bytes and registers a thread (`ATTN_INFO`)."""
    lib = cuda_lib.load("lbf_layer", _SIGNATURE)
    code = cuda_lib.kernel_dtype(dtype)
    info = {k: lib.lbf_layer_attn_info(code, nv, i)
            for i, k in enumerate(ATTN_INFO)}
    if min(info.values()) < 0:
        raise RuntimeError(f"lbf_layer_attn_info: CUDA error ({info})")
    return info


def lbf_layer_rows(verts: torch.Tensor, joints: torch.Tensor,
                   weights: cuda_lib.Packed):
    """The row-local launch of csrc/lbf_layer.cu alone, on contiguous CUDA
    tensors -> (y3 f32, q2, k2, v2) [B, Nv, C], the self-attention's
    inputs."""
    b, nv, _ = verts.shape
    lib = cuda_lib.load("lbf_layer", _SIGNATURE)
    y3 = torch.empty(verts.shape, dtype=torch.float32, device=verts.device)
    q2, k2, v2 = (torch.empty_like(verts) for _ in range(3))
    err = lib.lbf_layer_rows_launch(
        cuda_lib.kernel_dtype(verts.dtype), verts.data_ptr(),
        joints.data_ptr(), weights.flat.data_ptr(),
        weights.offsets.data_ptr(), y3.data_ptr(), q2.data_ptr(),
        k2.data_ptr(), v2.data_ptr(), b, nv, joints.shape[1],
        cuda_lib.stream_ptr(verts))
    cuda_lib.check(err, "lbf_layer_rows_launch")
    lbf_layer.launches += 1
    return y3, q2, k2, v2


def lbf_layer_cuda(verts: torch.Tensor, joints: torch.Tensor,
                   weights: cuda_lib.Packed) -> torch.Tensor:
    """Launch csrc/lbf_layer.cu (a row-local kernel, then the
    self-attention) on CUDA tensors."""
    check_layer_args("lbf_layer", verts, joints, weights)
    b, nv, c = verts.shape
    out = torch.empty_like(verts)
    if b == 0 or nv == 0:
        return out
    lib = cuda_lib.load("lbf_layer", _SIGNATURE)
    y3, q2, k2, v2 = lbf_layer_rows(verts.contiguous(), joints.contiguous(),
                                    weights)
    err = lib.lbf_layer_attn_launch(
        cuda_lib.kernel_dtype(verts.dtype), q2.data_ptr(), k2.data_ptr(),
        v2.data_ptr(), y3.data_ptr(), weights.flat.data_ptr(),
        weights.offsets.data_ptr(), out.data_ptr(), b, nv,
        cuda_lib.stream_ptr(verts))
    cuda_lib.check(err, "lbf_layer_attn_launch")
    lbf_layer.launches += 1
    return out


def lbf_layer(verts: torch.Tensor, joints: torch.Tensor,
              weights: cuda_lib.Packed, num_heads: int) -> torch.Tensor:
    """One LBF layer: the CUDA kernels for a CUDA tensor, the plain version
    for a CPU tensor (and nothing else: no fallback between the two)."""
    if verts.device.type == "cuda":
        if num_heads != HEADS:
            raise ValueError(f"lbf_layer kernels take {HEADS} heads")
        return lbf_layer_cuda(verts, joints, weights)
    if verts.device.type == "cpu":
        return lbf_layer_ref(verts, joints, weights, num_heads)
    raise ValueError(f"lbf_layer: unsupported device {verts.device}")


# launches of the CUDA kernels (two per layer); the CPU path never counts
lbf_layer.launches = 0
