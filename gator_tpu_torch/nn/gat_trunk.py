"""K1: the GAT trunk of the serving path (all blocks, inference only).

`gat_trunk` runs the hand-written CUDA kernel `csrc/gat_trunk.cu` on a CUDA
tensor and its plain PyTorch version `gat_trunk_ref` on a CPU tensor. It
replaces gator_tpu/nn/pallas_gat.py:266 `gat_blocks_fused`; the math of one
block is gator_tpu/nn/pallas_gat.py:325 `gat_block_xla` (reference:
lib/models/GAT.py:16-43).

The trunk's weights are folded once per serving function by
`fold_trunk_weights` into one packed tensor in the working dtype.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_lib
from .graph import symmetric_adjacency
from .layers import layer_norm32

# Field order of one block's packed weights; must match `enum Field` in
# csrc/gat_trunk.cu. Matrices are [in, out] (y = x @ W).
TRUNK_FIELDS = (
    "ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
    "gcn_w0", "gcn_w1", "gcn_m", "gcn_mdiag", "gcn_off", "gcn_b",
    "x0_w", "x0_b", "x1_w", "x1_b", "back_w", "back_b",
    "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
)

EMBED, HEADS, RING2 = 128, 8, 16
# shared-memory floats per token row (X, Y, Q, A buffers of the kernel)
_ROW_FLOATS = EMBED + (EMBED + RING2) + 3 * EMBED + EMBED
_ROWS_MAX = 64
_SMEM_MAX = 232448           # bytes of shared memory a CTA can use

_SIGNATURE = {"gat_trunk_launch": [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
    + [ctypes.c_void_p]}


def fold_trunk_weights(blocks, dtype: torch.dtype, device) -> cuda_lib.Packed:
    """Pack each `GATBlock`'s weights for the kernel: linear weights
    transposed to [in, out]; the MGCN adjacency symmetrised and split into
    its diagonal, folded into the modulation (mdiag = diag(adj) * M), and
    its off-diagonal part (as gator_tpu/nn/pallas_gat.py:59
    `extract_block_params` and :112 `fold_trunk_params`)."""
    layers = []
    with torch.no_grad():
        for blk in blocks:
            gcn = blk.gcn
            adj = symmetric_adjacency(gcn.adjacency, gcn.adj2.float())
            eye = torch.eye(adj.shape[0], device=adj.device)
            lin0, lin1 = blk.x_feat.linears
            layers.append({
                "ln1_w": blk.norm1.weight, "ln1_b": blk.norm1.bias,
                "qkv_w": blk.attn.qkv.weight.T, "qkv_b": blk.attn.qkv.bias,
                "proj_w": blk.attn.proj.weight.T,
                "proj_b": blk.attn.proj.bias,
                "gcn_w0": gcn.W[0], "gcn_w1": gcn.W[1], "gcn_m": gcn.M,
                "gcn_mdiag": torch.diagonal(adj)[:, None] * gcn.M,
                "gcn_off": adj * (1 - eye), "gcn_b": gcn.bias,
                "x0_w": lin0.weight.T, "x0_b": lin0.bias,
                "x1_w": lin1.weight.T, "x1_b": lin1.bias,
                "back_w": blk.x_feat.linearback.weight.T,
                "back_b": blk.x_feat.linearback.bias,
                "ln2_w": blk.norm2.weight, "ln2_b": blk.norm2.bias,
                "fc1_w": blk.mlp.fc1.weight.T, "fc1_b": blk.mlp.fc1.bias,
                "fc2_w": blk.mlp.fc2.weight.T, "fc2_b": blk.mlp.fc2.bias,
            })
    return cuda_lib.pack(layers, TRUNK_FIELDS, dtype, device)


def gat_trunk_ref(x: torch.Tensor, bias: torch.Tensor, masks: torch.Tensor,
                  weights: cuda_lib.Packed, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, rounding to the working dtype
    at the same places: x [B, J, C] (dtype of `weights`), bias [H, J, J]
    and masks [2, J, J] f32. The residual stream stays f32."""
    dt = weights.dtype

    def rnd(t):
        return t.to(dt).float()

    b, j, c = x.shape
    h = num_heads
    d = c // h
    bias = bias.float()
    m0, m1 = masks.float()
    x = x.float()
    for w in weights.layers:
        p = {k: v.float() for k, v in w.items()}
        y = rnd(layer_norm32(x, p["ln1_w"], p["ln1_b"]))
        qkv = rnd(y @ p["qkv_w"] + p["qkv_b"]).reshape(b, j, 3, h, d)
        s = torch.einsum("bnhd,bmhd->bhnm", qkv[:, :, 0], qkv[:, :, 1])
        prob = rnd(torch.softmax(s * d ** -0.5 + bias, dim=-1))
        o = rnd(torch.einsum("bhnm,bmhd->bnhd", prob, qkv[:, :, 2]))
        attn = rnd(o.reshape(b, j, c) @ p["proj_w"] + p["proj_b"])
        h0 = y @ p["gcn_w0"]
        h1 = rnd((y @ p["gcn_w1"]) * p["gcn_m"])
        z = rnd(attn + p["gcn_mdiag"] * h0
                + torch.einsum("ij,bjc->bic", p["gcn_off"], h1) + p["gcn_b"])
        f0 = rnd(z @ p["x0_w"] + p["x0_b"])
        f1 = rnd(z @ p["x1_w"] + p["x1_b"])
        ring = rnd(torch.cat([torch.einsum("ij,bjc->bic", m0, f0),
                              torch.einsum("ij,bjc->bic", m1, f1)], dim=-1))
        x = x + ring @ p["back_w"] + p["back_b"]
        y2 = rnd(layer_norm32(x, p["ln2_w"], p["ln2_b"]))
        hid = rnd(F.gelu(y2 @ p["fc1_w"] + p["fc1_b"]))
        x = x + hid @ p["fc2_w"] + p["fc2_b"]
    return x.to(dt)


def samples_per_cta(j: int) -> int:
    """Samples per CTA: as many as fit in 64 token rows and in shared
    memory."""
    g = max(1, _ROWS_MAX // j)
    while g > 1 and smem_bytes(j, g) > _SMEM_MAX:
        g -= 1
    return g


def smem_bytes(j: int, g: int) -> int:
    rows = -(-g * j // 8) * 8
    return 4 * (rows * _ROW_FLOATS + (HEADS + 2) * j * j)


def gat_trunk_cuda(x: torch.Tensor, bias: torch.Tensor, masks: torch.Tensor,
                   weights: cuda_lib.Packed) -> torch.Tensor:
    """Launch csrc/gat_trunk.cu on CUDA tensors."""
    b, j, c = x.shape
    if c != EMBED or bias.shape != (HEADS, j, j) or masks.shape != (2, j, j):
        raise ValueError(f"gat_trunk kernel takes C={EMBED}, {HEADS} heads: "
                         f"x {tuple(x.shape)}, bias {tuple(bias.shape)}, "
                         f"masks {tuple(masks.shape)}")
    if x.dtype != weights.dtype:
        raise TypeError(f"x is {x.dtype}, weights are {weights.dtype}")
    for t in (bias, masks, weights.flat, weights.offsets):
        if t.device != x.device:
            raise ValueError("gat_trunk: all tensors must be on x's device")
    g = samples_per_cta(j)
    smem = smem_bytes(j, g)
    if smem > _SMEM_MAX:
        raise ValueError(f"gat_trunk: J={j} needs {smem} bytes of shared "
                         "memory")
    lib = cuda_lib.load("gat_trunk", _SIGNATURE)
    x = x.contiguous()
    bias = bias.float().contiguous()
    masks = masks.float().contiguous()
    out = torch.empty_like(x)
    if b == 0:
        return out
    err = lib.gat_trunk_launch(
        cuda_lib.kernel_dtype(x.dtype), x.data_ptr(), bias.data_ptr(),
        masks.data_ptr(), weights.flat.data_ptr(), weights.offsets.data_ptr(),
        weights.flat.shape[1], weights.flat.shape[0], out.data_ptr(), b, j,
        g, smem, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, "gat_trunk_launch")
    gat_trunk.launches += 1
    return out


def gat_trunk(x: torch.Tensor, bias: torch.Tensor, masks: torch.Tensor,
              weights: cuda_lib.Packed, num_heads: int) -> torch.Tensor:
    """The GAT trunk: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor (and nothing else: no fallback between the two)."""
    if x.device.type == "cuda":
        if num_heads != HEADS:
            raise ValueError(f"gat_trunk kernel takes {HEADS} heads")
        return gat_trunk_cuda(x, bias, masks, weights)
    if x.device.type == "cpu":
        return gat_trunk_ref(x, bias, masks, weights, num_heads)
    raise ValueError(f"gat_trunk: unsupported device {x.device}")


# launches of the CUDA kernel; the CPU path never counts
gat_trunk.launches = 0
