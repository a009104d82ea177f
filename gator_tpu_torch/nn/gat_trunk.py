"""K1: the GAT trunk of the serving path (all blocks, inference only).

`gat_trunk` runs the hand-written CUDA kernel `csrc/gat_trunk.cu` on a CUDA
tensor and its plain PyTorch version `gat_trunk_ref` on a CPU tensor. It
replaces gator_tpu/nn/pallas_gat.py:266 `gat_blocks_fused`; the math of one
block is gator_tpu/nn/pallas_gat.py:325 `gat_block_xla` (reference:
lib/models/GAT.py:16-43).

The trunk's weights are folded once per serving function by
`fold_trunk_weights` into one packed tensor in the working dtype, and the
matrices also into the kernel's weight panels (`pack_panels`).

The kernel is built for the (embed width, heads) pairs of `WIDTHS`; every
other width is derived from the embed width C as the JAX model derives it
(qkv 3C, MLP hidden 4C, the second XFeat ring C / 8, head width C / 8).
`check_width` refuses any other pair on the card, for K1 and K5 alike.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Tuple

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
PANEL_COLS, MLP_CHUNK = 64, 64

# (embed_dim, num_heads) pairs the GAT kernels K1 and K5 are built for
# (`Width` in csrc/gat_trunk.cu and csrc/gat_trunk_train.cu)
WIDTHS = ((64, 8), (128, 8))
HEADS = 8
JOINTS_MAX = 19              # `JMAX` of the kernel
# token rows of a CTA's tile (`Tile<T, C>::RT`): 5 and 3 tiles of 16 rows
TILE_ROWS = {torch.bfloat16: 80, torch.float32: 48}
SMEM_MAX = 232448            # bytes of shared memory a CTA can use

_SIGNATURE = {
    "gat_trunk_launch": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "gat_trunk_info": [ctypes.c_int] * 3,
}


@dataclasses.dataclass
class TrunkWeights(cuda_lib.Packed):
    """The trunk's packed fields (`gat_trunk_ref` reads them) and the same
    matrices as the kernel's weight panels (`pack_panels`)."""

    panels: torch.Tensor


def check_width(embed_dim: int, num_heads: int) -> None:
    """Refuse an (embed_dim, num_heads) pair the GAT kernels K1 and K5 are
    not built for; every CUDA build of a GAT model, serving function or
    train step calls it before any launch. The plain versions take any
    width."""
    if (int(embed_dim), int(num_heads)) not in WIDTHS:
        raise ValueError(
            f"the GAT kernels K1 and K5 take (embed_dim, num_heads) in "
            f"{list(WIDTHS)}, got ({embed_dim}, {num_heads})")


def products(c: int) -> Tuple[Tuple[str, int, int], ...]:
    """The kernel's products at embed width c in the order it runs them
    ([in, out] sizes; `enum Prod`); the MLP's fc1 / fc2 follow in chunks
    of MLP_CHUNK hidden units."""
    c2 = c // 8
    return (("qkv_w", c, 3 * c), ("gcn_w1", c, c), ("proj_w", c, c),
            ("gcn_w0", c, c), ("x0_w", c, c), ("x1_w", c, c2),
            ("back_w", c + c2, c))


def panel_depth(dtype: torch.dtype) -> int:
    """Rows of a weight panel (`Tile<T, C>::KP`): 64 in bf16, 32 in f32."""
    return 64 if dtype == torch.bfloat16 else 32


def panel_order(kp: int, c: int) -> List[Tuple[str, int, int]]:
    """(matrix, first row, first column) of each [kp, 64] panel of a block
    at embed width c in the order the kernel takes them: each product's
    column panels, each over its depth panels; then per chunk of MLP_CHUNK
    hidden units fc1's depth panels and fc2's, column panel by column
    panel."""
    order = []
    for name, k, n in products(c):
        for c0 in range(0, n, PANEL_COLS):
            order += [(name, r0, c0) for r0 in range(0, k, kp)]
    for h0 in range(0, 4 * c, MLP_CHUNK):
        order += [("fc1_w", r0, h0) for r0 in range(0, c, kp)]
        for c0 in range(0, c, PANEL_COLS):
            order += [("fc2_w", h0 + r0, c0)
                      for r0 in range(0, MLP_CHUNK, kp)]
    return order


def pack_panels(layers, dtype: torch.dtype) -> torch.Tensor:
    """Every block's matrices as the kernel's weight panels, in its order
    (`panel_order`): each [kp, 64] block zero past its matrix's edge, with
    the 16-byte pieces of row k permuted, piece j at j ^ (k & 7) in bf16 and
    at j ^ ((k & 7) << 1) in f32, so that the kernel's fragment loads fall
    in distinct banks. -> [blocks * panels * kp * 64] in `dtype`."""
    kp = panel_depth(dtype)
    per = 16 // torch.empty((), dtype=dtype).element_size()
    pieces = PANEL_COLS // per
    device = layers[0]["qkv_w"].device
    c = layers[0]["qkv_w"].shape[0]
    k = torch.arange(kp, device=device)
    swz = (k & 7) if dtype == torch.bfloat16 else (k & 7) << 1
    where = torch.arange(pieces, device=device)[None, :] ^ swz[:, None]
    out = []
    for layer in layers:
        for name, r0, c0 in panel_order(kp, c):
            w = layer[name]
            blk = w.new_zeros(kp, PANEL_COLS)
            part = w[r0:r0 + kp, c0:c0 + PANEL_COLS]
            blk[:part.shape[0], :part.shape[1]] = part
            blk = blk.view(kp, pieces, per)
            out.append(blk[k[:, None], where].reshape(-1))
    return torch.cat(out)


def fold_trunk_weights(blocks, dtype: torch.dtype, device) -> TrunkWeights:
    """Pack each `GATBlock`'s weights for the kernel: linear weights
    transposed to [in, out]; the MGCN adjacency symmetrised and split into
    its diagonal, folded into the modulation (mdiag = diag(adj) * M), and
    its off-diagonal part (as gator_tpu/nn/pallas_gat.py:59
    `extract_block_params` and :112 `fold_trunk_params`); the matrices
    also as the kernel's weight panels."""
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
    packed = cuda_lib.pack(layers, TRUNK_FIELDS, dtype, device)
    return TrunkWeights(packed.flat, packed.offsets, packed.layers,
                        pack_panels(packed.layers, dtype))


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


def smem_bytes(dtype: torch.dtype, c: int) -> int:
    """Shared memory of one CTA at embed width c (`Tile<T, C>::BYTES`): per
    token row the f32 residual stream X (C + 4 floats) and, in the working
    dtype T padded by 16 bytes, Y (C), P (3C) and O (the XFeat concat C +
    C / 8, padded to a multiple of 16); then the ring's slots (4 in
    bf16, 3 in f32) of a [KP, 64] weight panel (`panel_depth`); three
    [32, 32] tables in T, rows padded by 16 bytes (the hop-ring masks and
    the MGCN off-diagonal adjacency, zero past J); and, in f32, a block's
    constants (`enum Konst`: the biases and LayerNorm weights, M and
    mdiag) and the [HEADS, JOINTS_MAX, JOINTS_MAX] hop/path bias."""
    t = torch.empty((), dtype=dtype).element_size()
    e = 16 // t
    rows = TILE_ROWS[dtype]
    kp, slots = panel_depth(dtype), (4 if t == 2 else 3)
    c2 = c // 8
    cfp = -(-(c + c2) // 16) * 16
    per_row = (c + 4) * 4 + t * ((c + e) + (3 * c + e) + (cfp + e))
    tables = 3 * 32 * (32 + e) * t
    consts = 12 * c + c2 + 4 * c + 2 * JOINTS_MAX * c
    bias = HEADS * JOINTS_MAX * JOINTS_MAX
    return (rows * per_row + slots * kp * PANEL_COLS * t + tables
            + 4 * (consts + bias))


def samples_per_cta(j: int, dtype: torch.dtype) -> int:
    """The most whole samples of j joints a CTA's tile holds."""
    if not 1 <= j <= JOINTS_MAX:
        raise ValueError(f"gat_trunk kernel takes 1..{JOINTS_MAX} joints, "
                         f"got {j}")
    return TILE_ROWS[dtype] // j


def launch_plan(b: int, j: int, dtype: torch.dtype,
                sms: int) -> Dict[str, int]:
    """K1's grid for b samples of j joints on a card of `sms` SMs (one CTA
    fits an SM): the fewest waves of CTAs the tile allows, then the fewest
    samples per CTA (`g`) that keep that many waves, so that a small batch
    spreads over the SMs (B = 256 at J = 17: 128 CTAs of 2 samples) and a
    large one fills its last wave as far as it can."""
    if b < 1:
        raise ValueError(f"gat_trunk kernel needs a batch, got {b}")

    def cdiv(n, d):
        return -(-n // d)

    waves = cdiv(cdiv(b, samples_per_cta(j, dtype)), sms)
    g = cdiv(b, waves * sms)
    return {"g": g, "ctas": cdiv(b, g), "waves": waves, "rows": g * j}


_SMS: Dict[int, int] = {}


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def kernel_info(dtype: torch.dtype, c: int) -> Dict[str, int]:
    """Registers a thread, CTAs resident per SM, shared-memory bytes, token
    rows a tile, threads a CTA, weight panels a block and panel depth of
    the K1 kernel for `dtype` at embed width c, from the current card."""
    check_width(c, HEADS)
    lib = cuda_lib.load("gat_trunk", _SIGNATURE)
    code = cuda_lib.kernel_dtype(dtype)
    return {what: lib.gat_trunk_info(code, c, w) for w, what in enumerate(
        ("registers", "ctas_per_sm", "smem_bytes", "rows", "threads",
         "panels", "panel_depth"))}


def gat_trunk_cuda(x: torch.Tensor, bias: torch.Tensor, masks: torch.Tensor,
                   weights: TrunkWeights) -> torch.Tensor:
    """Launch csrc/gat_trunk.cu on CUDA tensors."""
    b, j, c = x.shape
    check_width(c, bias.shape[0])
    if (bias.shape != (HEADS, j, j) or masks.shape != (2, j, j)
            or weights.layers[0]["qkv_w"].shape[0] != c):
        raise ValueError(f"gat_trunk kernel: x {tuple(x.shape)}, bias "
                         f"{tuple(bias.shape)}, masks {tuple(masks.shape)}, "
                         f"weights of width "
                         f"{weights.layers[0]['qkv_w'].shape[0]}")
    if x.dtype != weights.dtype:
        raise TypeError(f"x is {x.dtype}, weights are {weights.dtype}")
    for t in (bias, masks, weights.flat, weights.offsets, weights.panels):
        if t.device != x.device:
            raise ValueError("gat_trunk: all tensors must be on x's device")
    lib = cuda_lib.load("gat_trunk", _SIGNATURE)
    x = x.contiguous()
    bias = bias.float().contiguous()
    masks = masks.float().contiguous()
    out = torch.empty_like(x)
    if b == 0:
        return out
    plan = launch_plan(b, j, x.dtype, _sms(x.device))
    err = lib.gat_trunk_launch(
        cuda_lib.kernel_dtype(x.dtype), c, x.data_ptr(), bias.data_ptr(),
        masks.data_ptr(), weights.flat.data_ptr(), weights.offsets.data_ptr(),
        weights.flat.shape[1], weights.panels.data_ptr(),
        weights.flat.shape[0], out.data_ptr(), b, j, plan["g"],
        cuda_lib.stream_ptr(x))
    cuda_lib.check(err, "gat_trunk_launch")
    gat_trunk.launches += 1
    return out


def gat_trunk(x: torch.Tensor, bias: torch.Tensor, masks: torch.Tensor,
              weights: cuda_lib.Packed, num_heads: int) -> torch.Tensor:
    """The GAT trunk: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor (and nothing else: no fallback between the two)."""
    if x.device.type == "cuda":
        check_width(x.shape[-1], num_heads)
        return gat_trunk_cuda(x, bias, masks, weights)
    if x.device.type == "cpu":
        return gat_trunk_ref(x, bias, masks, weights, num_heads)
    raise ValueError(f"gat_trunk: unsupported device {x.device}")


# launches of the CUDA kernel; the CPU path never counts
gat_trunk.launches = 0
