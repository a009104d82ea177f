"""K5: the GAT block in training mode (dropout, DropPath, hand-derived
backward), counterpart of gator_tpu/nn/pallas_gat_train.py.

`gat_trunk_train` runs each block as `GatBlockTrain`, an autograd Function
whose forward and backward are the hand-written CUDA kernels of
`csrc/gat_trunk_train.cu`, on a CUDA tensor; on a CPU tensor it runs the
plain version `gat_block_train_ref` with the same masks (from
`dropout_masks`) under torch autograd. It replaces
gator_tpu/nn/pallas_gat_train.py:530 `gat_trunk_train`.

Parameters are the 25 tensors of `BLOCK_PARAM_KEYS`, taken from a
`GATBlock` by `extract_block_params` with differentiable torch ops (adj2
symmetrised and split into its diagonal and off-diagonal parts, linear
weights transposed to [in, out], `linearback` split in two halves), so the
Function's gradients flow back to the module's parameters through autograd.
The Function packs them (detached) inside its forward and returns one
gradient per input.

Dtypes, as the JAX kernel: the block output and dx are in x's dtype (a
bf16 residual stream is rounded to bf16 at each block boundary), every
matmul rounds its operands to that dtype and accumulates in f32, the
hop/path bias and all parameter gradients are f32.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_lib
from .dropout_masks import (GAT_UNIT_BASE, M_ATTN0, M_DP1, M_DP2, M_MLP1,
                            M_MLP2, M_PROJ, keep_mask, keep_scale, threshold)
from .graph import symmetric_adjacency

# per-block parameter keys, in the kernel's field order (`enum Field` in
# csrc/gat_trunk_train.cu); gator_tpu/nn/pallas_gat.py:49 BLOCK_PARAM_KEYS
BLOCK_PARAM_KEYS = (
    "norm1_scale", "norm1_bias",
    "qkv_w", "qkv_b", "proj_w", "proj_b",
    "gcn_w0", "gcn_w1", "gcn_m", "gcn_adj_diag", "gcn_adj_off", "gcn_b",
    "x0_w", "x0_b", "x1_w", "x1_b", "back_w0", "back_w1", "back_b",
    "norm2_scale", "norm2_bias",
    "fc1_w", "fc1_b", "fc2_w", "fc2_b",
)

EMBED, HEADS, HIDDEN, RING2, JOINTS_MAX = 128, 8, 512, 16, 32
ROWS = 64                    # token rows per CTA group
NCTA_MAX = 264               # grid of both kernels (2 CTAs per H100 SM)

_RATE_ARGS = [ctypes.c_uint, ctypes.c_float] * 4
_SIGNATURE = {
    "gat_block_train_scratch": [ctypes.c_int],
    "gat_block_train_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 4 + [ctypes.c_uint, ctypes.c_int] + _RATE_ARGS
    + [ctypes.c_void_p],
    "gat_block_train_bwd": [ctypes.c_int] + [ctypes.c_void_p] * 9
    + [ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 5
    + [ctypes.c_uint, ctypes.c_int] + _RATE_ARGS + [ctypes.c_void_p],
}


def extract_block_params(blk) -> Dict[str, torch.Tensor]:
    """One `GATBlock`'s parameters in `BLOCK_PARAM_KEYS` form, computed
    with differentiable ops (gator_tpu/nn/pallas_gat.py:59
    `extract_block_params`; reference: lib/models/backbones/
    modules.py:243-249 for the adjacency)."""
    gcn = blk.gcn
    adj = symmetric_adjacency(gcn.adjacency, gcn.adj2.float())
    eye = torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device)
    lin0, lin1 = blk.x_feat.linears
    back_w = blk.x_feat.linearback.weight.T
    c = lin0.weight.shape[0]
    return {
        "norm1_scale": blk.norm1.weight, "norm1_bias": blk.norm1.bias,
        "qkv_w": blk.attn.qkv.weight.T, "qkv_b": blk.attn.qkv.bias,
        "proj_w": blk.attn.proj.weight.T, "proj_b": blk.attn.proj.bias,
        "gcn_w0": gcn.W[0], "gcn_w1": gcn.W[1], "gcn_m": gcn.M,
        "gcn_adj_diag": torch.diagonal(adj)[:, None],
        "gcn_adj_off": adj * (1 - eye), "gcn_b": gcn.bias,
        "x0_w": lin0.weight.T, "x0_b": lin0.bias,
        "x1_w": lin1.weight.T, "x1_b": lin1.bias,
        "back_w0": back_w[:c], "back_w1": back_w[c:],
        "back_b": blk.x_feat.linearback.bias,
        "norm2_scale": blk.norm2.weight, "norm2_bias": blk.norm2.bias,
        "fc1_w": blk.mlp.fc1.weight.T, "fc1_b": blk.mlp.fc1.bias,
        "fc2_w": blk.mlp.fc2.weight.T, "fc2_b": blk.mlp.fc2.bias,
    }


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One block's dropout configuration (gator_tpu GatBlockCfg)."""

    num_heads: int
    block: int
    seed: int
    attn_rate: float = 0.4
    proj_rate: float = 0.4
    mlp_rate: float = 0.1        # GatMlp's fixed 0.1 (reference quirk)
    path_rate: float = 0.0

    @property
    def unit(self) -> int:
        return GAT_UNIT_BASE + self.block

    def rate_args(self) -> list:
        out = []
        for rate in (self.attn_rate, self.proj_rate, self.mlp_rate,
                     self.path_rate):
            out += [threshold(rate), keep_scale(rate)]
        return out


def block_masks(cfg: BlockCfg, batch: int, j: int, c: int,
                device=None) -> Dict[str, Optional[torch.Tensor]]:
    """The masks the kernels draw for one block, as the explicit-mask
    arrays of `gat_block_train_ref`: attn [B,H,J,J], proj [B,J,C],
    dp1/dp2 [B,1,1], mlp1 [B,J,4C], mlp2 [B,J,C] (None at rate 0)."""
    s, u = cfg.seed, cfg.unit
    heads = [keep_mask(s, u, M_ATTN0 + h, cfg.attn_rate, batch, (j, j),
                       device) for h in range(cfg.num_heads)]
    return {
        "attn": None if heads[0] is None else torch.stack(heads, 1),
        "proj": keep_mask(s, u, M_PROJ, cfg.proj_rate, batch, (j, c), device),
        "dp1": keep_mask(s, u, M_DP1, cfg.path_rate, batch, (1, 1), device),
        "mlp1": keep_mask(s, u, M_MLP1, cfg.mlp_rate, batch, (j, 4 * c),
                          device),
        "mlp2": keep_mask(s, u, M_MLP2, cfg.mlp_rate, batch, (j, c), device),
        "dp2": keep_mask(s, u, M_DP2, cfg.path_rate, batch, (1, 1), device),
    }


def _ap(t: torch.Tensor, m: Optional[torch.Tensor]) -> torch.Tensor:
    return t if m is None else t * m


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w, b, 1e-5)


def gat_block_train_ref(x: torch.Tensor, bias: torch.Tensor,
                        p: Dict[str, torch.Tensor], masks_xfeat,
                        masks: Dict[str, Optional[torch.Tensor]],
                        num_heads: int) -> torch.Tensor:
    """Plain version of one training block with explicit scaled masks
    (gator_tpu/nn/pallas_gat_train.py:561 `gat_block_train_ref`): x
    [B, J, C], bias [H, J, J], masks as `block_masks`. Matmul operands are
    rounded to x's dtype, as the kernel rounds them; in f32 that is the JAX
    oracle's math."""
    dt = x.dtype

    def r(t):
        return t.to(dt).float()

    b, j, c = x.shape
    h = num_heads
    d = c // h
    p = {k: r(v) for k, v in p.items()}   # the kernel packs them in dt
    x32 = x.float()
    m = masks.get
    y = _ln(x32, p["norm1_scale"], p["norm1_bias"])
    qkv = (r(y) @ r(p["qkv_w"]) + p["qkv_b"]).reshape(b, j, 3, h, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    s = torch.einsum("bnhd,bmhd->bhnm", r(q), r(k)) * d ** -0.5 \
        + bias.float()[None]
    pd = _ap(torch.softmax(s, dim=-1), m("attn"))
    a1 = torch.einsum("bhnm,bmhd->bnhd", r(pd), r(v)).reshape(b, j, c)
    attn = _ap(r(a1) @ r(p["proj_w"]) + p["proj_b"], m("proj"))
    mt = p["gcn_m"]
    h0 = (r(y) @ r(p["gcn_w0"])) * mt
    h1 = (r(y) @ r(p["gcn_w1"])) * mt
    gcn = r(p["gcn_adj_diag"]) * h0 \
        + torch.einsum("ij,bjc->bic", r(p["gcn_adj_off"]), r(h1)) \
        + p["gcn_b"]
    z = _ap(attn + gcn, m("dp1"))
    m0, m1 = torch.as_tensor(masks_xfeat, dtype=torch.float32,
                             device=x.device)[:2]
    f0 = torch.einsum("ij,bjc->bic", m0,
                      r(r(z) @ r(p["x0_w"]) + p["x0_b"]))
    f1 = torch.einsum("ij,bjc->bic", m1,
                      r(r(z) @ r(p["x1_w"]) + p["x1_b"]))
    x1 = x32 + (r(f0) @ r(p["back_w0"]) + r(f1) @ r(p["back_w1"])
                + p["back_b"])
    y2 = _ln(x1, p["norm2_scale"], p["norm2_bias"])
    hh = _ap(F.gelu(r(y2) @ r(p["fc1_w"]) + p["fc1_b"]), m("mlp1"))
    mm2 = _ap(r(hh) @ r(p["fc2_w"]) + p["fc2_b"], m("mlp2"))
    return (x1 + _ap(mm2, m("dp2"))).to(dt)


# --- the CUDA path ---------------------------------------------------------

def _layout(j: int, device) -> Dict:
    """Element offsets of the packed fields (8-aligned), the weight stride
    and the gradient stride (the fields, then the [H, J, J] bias)."""
    key = (j, str(device))
    if key not in _LAYOUTS:
        c = EMBED
        shapes = {
            "norm1_scale": (c,), "norm1_bias": (c,),
            "qkv_w": (c, 3 * c), "qkv_b": (3 * c,),
            "proj_w": (c, c), "proj_b": (c,),
            "gcn_w0": (c, c), "gcn_w1": (c, c), "gcn_m": (j, c),
            "gcn_adj_diag": (j, 1), "gcn_adj_off": (j, j), "gcn_b": (c,),
            "x0_w": (c, c), "x0_b": (c,), "x1_w": (c, RING2),
            "x1_b": (RING2,), "back_w0": (c, c), "back_w1": (RING2, c),
            "back_b": (c,), "norm2_scale": (c,), "norm2_bias": (c,),
            "fc1_w": (c, HIDDEN), "fc1_b": (HIDDEN,),
            "fc2_w": (HIDDEN, c), "fc2_b": (c,),
        }
        offsets, pos = cuda_lib.field_offsets(
            np.prod(shapes[name]) for name in BLOCK_PARAM_KEYS)
        gstride = pos + -(-HEADS * j * j // 8) * 8
        _LAYOUTS[key] = {
            "offsets": offsets, "shapes": shapes, "wstride": pos,
            "gstride": gstride,
            "offs_dev": torch.tensor(offsets + [pos], dtype=torch.int32,
                                     device=device)}
    return _LAYOUTS[key]


_LAYOUTS: Dict = {}


def _check(x: torch.Tensor, bias: torch.Tensor, masks_xfeat: torch.Tensor,
           params: Sequence[torch.Tensor], num_heads: int) -> None:
    b, j, c = x.shape
    if (c != EMBED or num_heads != HEADS or not 1 <= j <= JOINTS_MAX
            or bias.shape != (HEADS, j, j)
            or masks_xfeat.shape[-2:] != (j, j)):
        raise ValueError(f"gat_trunk_train kernels take C={EMBED}, {HEADS} "
                         f"heads and 1..{JOINTS_MAX} joints: x "
                         f"{tuple(x.shape)}, bias {tuple(bias.shape)}")
    cuda_lib.kernel_dtype(x.dtype)
    for t in (bias, masks_xfeat, *params):
        if t.device != x.device:
            raise ValueError("gat_trunk_train: all tensors must be on x's "
                             "device")


def _geometry(b: int, j: int):
    g = max(1, ROWS // j)
    ngroups = -(-b // g)
    return g, min(ngroups, NCTA_MAX)


class GatBlockTrain(torch.autograd.Function):
    """One block on the K5 kernels: forward `gat_block_train_fwd`,
    backward `gat_block_train_bwd` (recompute, backpropagate, reduce the
    per-CTA gradient partials). Inputs: x [B, J, 128] (f32 or bf16), the
    hop/path bias [8, J, J] (gets a gradient), the XFeat masks [2, J, J]
    (constants), a `BlockCfg`, an optional dict that receives the exported
    masks, then the 25 parameters in BLOCK_PARAM_KEYS order. The output
    and dx are in x's dtype, as the JAX kernel writes them
    (pallas_gat_train.py:350): a bf16 stream is rounded at each block
    boundary; dbias and the parameter gradients are f32."""

    @staticmethod
    def forward(ctx, x, bias, masks_xfeat, cfg: BlockCfg, export, *params):
        _check(x, bias, masks_xfeat, params, cfg.num_heads)
        b, j, c = x.shape
        lay = _layout(j, x.device)
        lib = cuda_lib.load("gat_trunk_train", _SIGNATURE)
        x = x.contiguous()
        bias32 = bias.detach().float().contiguous()
        xm = masks_xfeat.detach().float()[:2].contiguous()
        w = cuda_lib.pack_fields(params, lay["offsets"], lay["wstride"],
                                 x.dtype)
        out = torch.empty_like(x)
        g, nctas = _geometry(b, j)
        mask_buf = None
        if export is not None:
            mask_buf = torch.empty(
                b * (HEADS * j * j + 2 * j * c + j * HIDDEN + 2),
                dtype=torch.float32, device=x.device)
        if b > 0:
            scratch = torch.empty(
                nctas * lib.gat_block_train_scratch(0), dtype=torch.float32,
                device=x.device)
            err = lib.gat_block_train_fwd(
                cuda_lib.kernel_dtype(x.dtype), x.data_ptr(),
                bias32.data_ptr(), xm.data_ptr(), w.data_ptr(),
                lay["offs_dev"].data_ptr(), out.data_ptr(),
                scratch.data_ptr(),
                None if mask_buf is None else mask_buf.data_ptr(), b, j, g,
                nctas, cfg.seed, cfg.unit, *cfg.rate_args(),
                cuda_lib.stream_ptr(x))
            cuda_lib.check(err, "gat_block_train_fwd")
            gat_trunk_train.launches_fwd += 1
        if export is not None:
            export.update(_split_masks(mask_buf, b, j, c))
        ctx.cfg = cfg
        ctx.save_for_backward(x, bias32, xm, w, *params)
        return out

    @staticmethod
    def backward(ctx, gout):
        cfg = ctx.cfg
        x, bias32, xm, w, *params = ctx.saved_tensors
        b, j, c = x.shape
        lay = _layout(j, x.device)
        lib = cuda_lib.load("gat_trunk_train", _SIGNATURE)
        gout = gout.to(x.dtype).contiguous()
        dx = torch.empty_like(x)
        g, nctas = _geometry(b, j)
        grads = torch.zeros(lay["gstride"], dtype=torch.float32,
                            device=x.device)
        if b > 0:
            scratch = torch.empty(
                nctas * lib.gat_block_train_scratch(1), dtype=torch.float32,
                device=x.device)
            part = torch.zeros(nctas, lay["gstride"], dtype=torch.float32,
                               device=x.device)
            err = lib.gat_block_train_bwd(
                cuda_lib.kernel_dtype(x.dtype), x.data_ptr(),
                bias32.data_ptr(), xm.data_ptr(), w.data_ptr(),
                lay["offs_dev"].data_ptr(), gout.data_ptr(), dx.data_ptr(),
                scratch.data_ptr(), part.data_ptr(), lay["gstride"],
                grads.data_ptr(), lay["gstride"], b, j, g, nctas, cfg.seed,
                cfg.unit, *cfg.rate_args(), cuda_lib.stream_ptr(x))
            cuda_lib.check(err, "gat_block_train_bwd")
            gat_trunk_train.launches_bwd += 2
        dparams = []
        for name, off, p in zip(BLOCK_PARAM_KEYS, lay["offsets"], params):
            dparams.append(grads[off:off + p.numel()].view(p.shape).to(
                p.dtype))
        wst = lay["wstride"]
        dbias = grads[wst:wst + HEADS * j * j].view(HEADS, j, j)
        return (dx, dbias, None, None, None, *dparams)


def _split_masks(buf: torch.Tensor, b: int, j: int,
                 c: int) -> Dict[str, torch.Tensor]:
    sizes = [("attn", (b, HEADS, j, j)), ("proj", (b, j, c)),
             ("dp1", (b, 1, 1)), ("mlp1", (b, j, HIDDEN)),
             ("mlp2", (b, j, c)), ("dp2", (b, 1, 1))]
    out, pos = {}, 0
    for name, shape in sizes:
        n = int(np.prod(shape))
        out[name] = buf[pos:pos + n].view(shape)
        pos += n
    return out


def _trunk(x, bias, block_params, masks_xfeat, num_heads, seed, attn_rate,
           proj_rate, mlp_rate, drop_path_rate, export, kernel: bool):
    depth = len(block_params)
    dpr = np.linspace(0.0, drop_path_rate, depth)
    b, j, c = x.shape
    xm = torch.as_tensor(masks_xfeat, dtype=torch.float32,
                         device=x.device)
    for bi, bp in enumerate(block_params):
        cfg = BlockCfg(num_heads=num_heads, block=bi, seed=int(seed),
                       attn_rate=attn_rate, proj_rate=proj_rate,
                       mlp_rate=mlp_rate, path_rate=float(dpr[bi]))
        if kernel:
            got = None if export is None else {}
            x = GatBlockTrain.apply(x, bias, xm, cfg, got,
                                    *[bp[k] for k in BLOCK_PARAM_KEYS])
        else:
            got = block_masks(cfg, b, j, c, x.device)
            x = gat_block_train_ref(x, bias, bp, xm, got, num_heads)
        if export is not None:
            export.append(got)
    return x


def gat_trunk_train_ref(x: torch.Tensor, bias: torch.Tensor,
                        block_params: Sequence[Dict[str, torch.Tensor]],
                        masks_xfeat, num_heads: int, seed: int,
                        attn_rate: float = 0.4, proj_rate: float = 0.4,
                        mlp_rate: float = 0.1, drop_path_rate: float = 0.2,
                        export: Optional[List[Dict]] = None) -> torch.Tensor:
    """The trunk on the plain version, on any device, with the masks the
    kernels draw (the plain path of the train steps)."""
    return _trunk(x, bias, block_params, masks_xfeat, num_heads, seed,
                  attn_rate, proj_rate, mlp_rate, drop_path_rate, export,
                  kernel=False)


def gat_trunk_train(x: torch.Tensor, bias: torch.Tensor,
                    block_params: Sequence[Dict[str, torch.Tensor]],
                    masks_xfeat, num_heads: int, seed: int,
                    attn_rate: float = 0.4, proj_rate: float = 0.4,
                    mlp_rate: float = 0.1, drop_path_rate: float = 0.2,
                    export: Optional[List[Dict]] = None) -> torch.Tensor:
    """The lifter trunk in training mode (gator_tpu/nn/pallas_gat_train.py
    :530): one `GatBlockTrain` per block on a CUDA tensor, the plain
    version with the hash's masks on a CPU tensor (no fallback between
    them). DropPath rates are linspace(0, drop_path_rate, depth). bias:
    [H, J, J] (differentiable); masks_xfeat: [2, J, J] constants. With
    `export` (a list), each block's masks are appended to it: those the
    kernel exported, or those the plain version used."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"gat_trunk_train: unsupported device {x.device}")
    return _trunk(x, bias, block_params, masks_xfeat, num_heads, seed,
                  attn_rate, proj_rate, mlp_rate, drop_path_rate, export,
                  kernel=x.device.type == "cuda")


# launches of the CUDA kernels (forward and backward apart); the CPU path
# never counts
gat_trunk_train.launches_fwd = 0
gat_trunk_train.launches_bwd = 0
