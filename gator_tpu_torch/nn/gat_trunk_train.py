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

On the card a block takes four kernels (csrc/gat_trunk_train.cu): the
forward, one CTA per tile of TILE_ROWS token rows holding whole samples,
which also saves per row the operands its backward reads (`ops`); the
backward per tile, which writes dx, the weight gradients' cotangent
operands and the tile's bias, LayerNorm, MGCN-graph and hop/path-bias sums;
`gat_block_wgrad`, the ten weight gradients over all B * J rows in
`launch_plan`'s chunks; and the fixed-order reduction of chunks and tiles.
Dense products run on the tensor cores, activations stay in shared memory.

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
from .gat_trunk import HEADS, check_width
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

JOINTS_MAX = 32
TILE_ROWS = 32               # token rows of a CTA's tile (csrc RT): G = 32 // J
WGRAD_ROWS = 64              # rows of one gat_block_wgrad chain
WGRAD_CHUNKS = 8             # row chunks of gat_block_wgrad (grid 68 x
#                              chunks at C = 128, 18 x chunks at C = 64)
GRID_MAX = 2 ** 31 - 1       # CTAs of a 1-D grid on the card

# the ten matrices whose gradients gat_block_wgrad forms from `ops`; the other
# fields and the hop/path bias are summed per tile (`spart`)
WEIGHT_KEYS = ("qkv_w", "proj_w", "gcn_w0", "gcn_w1", "x0_w", "x1_w",
               "back_w0", "back_w1", "fc1_w", "fc2_w")

_RATE_ARGS = [ctypes.c_uint, ctypes.c_float] * 4
_SIGNATURE = {
    "gat_block_train_op_cols": [ctypes.c_int],
    "gat_block_train_info": [ctypes.c_int] * 4,
    "gat_block_train_fwd": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 4 + [ctypes.c_uint, ctypes.c_int, ctypes.c_int]
    + _RATE_ARGS + [ctypes.c_void_p],
    "gat_block_train_bwd": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
    + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
    + [ctypes.c_uint, ctypes.c_int, ctypes.c_int] + _RATE_ARGS
    + [ctypes.c_void_p],
}


def launch_plan(b: int, j: int) -> Dict[str, int]:
    """The K5 launches' geometry for a batch of b samples of j joints:
    g samples per tile (whole samples, g * j <= TILE_ROWS rows), one CTA
    per tile (`ntiles`, any batch: a 1-D grid), and gat_block_wgrad's rows
    in `nc_w` chunks of `wper` (a multiple of WGRAD_ROWS). Refuses what
    the kernels do not take."""
    if b < 1:
        raise ValueError(f"gat_trunk_train kernels need a batch, got {b}")
    if not 1 <= j <= JOINTS_MAX:
        raise ValueError(f"gat_trunk_train kernels take 1..{JOINTS_MAX} "
                         f"joints, got {j}")
    rows = b * j
    g = TILE_ROWS // j
    ntiles = -(-b // g)
    if ntiles > GRID_MAX or rows > GRID_MAX:
        raise ValueError(f"gat_trunk_train: {b} samples of {j} joints "
                         "exceed the card's grid")
    chains = -(-rows // WGRAD_ROWS)
    wper = -(-chains // min(WGRAD_CHUNKS, chains)) * WGRAD_ROWS
    return {"g": g, "ntiles": ntiles, "rows": rows, "wper": wper,
            "nc_w": -(-rows // wper)}


def partial_strides(j: int, c: int) -> Dict[str, int]:
    """Floats in a row of gat_block_wgrad's chunk partials (`weights`: the
    ten WEIGHT_KEYS) and of a tile's small gradients (`small`) at embed
    width c."""
    lay = _layout(j, c, "cpu")
    return {"weights": lay["gwstride"], "small": lay["gsstride"]}


def kernel_info(dtype: torch.dtype, c: int) -> Dict[str, Dict[str, int]]:
    """Registers a thread, CTAs resident per SM and shared-memory bytes of
    the three K5 kernels for `dtype` at embed width c, from the current
    card."""
    check_width(c, HEADS)
    lib = cuda_lib.load("gat_trunk_train", _SIGNATURE)
    code = cuda_lib.kernel_dtype(dtype)
    return {name: {what: lib.gat_block_train_info(code, c, k, w)
                   for w, what in enumerate(("registers", "ctas_per_sm",
                                             "smem_bytes"))}
            for k, name in enumerate(("gat_block_fwd", "gat_block_bwd",
                                      "gat_block_wgrad"))}


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
    """One block's dropout configuration (gator_tpu GatBlockCfg).
    sample0: the global index of the batch's first sample, which keys the
    masks (a data-parallel rank's first row)."""

    num_heads: int
    block: int
    seed: int
    attn_rate: float = 0.4
    proj_rate: float = 0.4
    mlp_rate: float = 0.1        # GatMlp's fixed 0.1 (reference quirk)
    path_rate: float = 0.0
    sample0: int = 0

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
    def mask(mid, rate, shape):
        return keep_mask(cfg.seed, cfg.unit, mid, rate, batch, shape, device,
                         cfg.sample0)

    heads = [mask(M_ATTN0 + h, cfg.attn_rate, (j, j))
             for h in range(cfg.num_heads)]
    return {
        "attn": None if heads[0] is None else torch.stack(heads, 1),
        "proj": mask(M_PROJ, cfg.proj_rate, (j, c)),
        "dp1": mask(M_DP1, cfg.path_rate, (1, 1)),
        "mlp1": mask(M_MLP1, cfg.mlp_rate, (j, 4 * c)),
        "mlp2": mask(M_MLP2, cfg.mlp_rate, (j, c)),
        "dp2": mask(M_DP2, cfg.path_rate, (1, 1)),
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

def _layout(j: int, c: int, device) -> Dict:
    """Element offsets of the packed fields (8-aligned) at embed width c
    and the weight stride; the gradients' two rows: the ten WEIGHT_KEYS in
    a row of
    `wstride` (gat_block_wgrad's chunks), the other fields and the [H, J, J]
    hop/path bias in a row of `sstride` (a tile's sums); `goffs` gives each
    field's offset in its row, in the kernel's field order."""
    key = (j, c, str(device))
    if key not in _LAYOUTS:
        c2, hidden = c // 8, 4 * c
        shapes = {
            "norm1_scale": (c,), "norm1_bias": (c,),
            "qkv_w": (c, 3 * c), "qkv_b": (3 * c,),
            "proj_w": (c, c), "proj_b": (c,),
            "gcn_w0": (c, c), "gcn_w1": (c, c), "gcn_m": (j, c),
            "gcn_adj_diag": (j, 1), "gcn_adj_off": (j, j), "gcn_b": (c,),
            "x0_w": (c, c), "x0_b": (c,), "x1_w": (c, c2),
            "x1_b": (c2,), "back_w0": (c, c), "back_w1": (c2, c),
            "back_b": (c,), "norm2_scale": (c,), "norm2_bias": (c,),
            "fc1_w": (c, hidden), "fc1_b": (hidden,),
            "fc2_w": (hidden, c), "fc2_b": (c,),
        }
        offsets, pos = cuda_lib.field_offsets(
            np.prod(shapes[name]) for name in BLOCK_PARAM_KEYS)
        small = [k for k in BLOCK_PARAM_KEYS if k not in WEIGHT_KEYS]
        woffs, wstride = cuda_lib.field_offsets(
            np.prod(shapes[k]) for k in WEIGHT_KEYS)
        soffs, sstride = cuda_lib.field_offsets(
            [np.prod(shapes[k]) for k in small] + [HEADS * j * j])
        goffs = {**dict(zip(WEIGHT_KEYS, woffs)), **dict(zip(small, soffs))}
        _LAYOUTS[key] = {
            "offsets": offsets, "shapes": shapes, "wstride": pos,
            "gwstride": wstride, "gsstride": sstride, "hop": soffs[-1],
            "goffs": goffs,
            "offs_dev": torch.tensor(offsets + [pos], dtype=torch.int32,
                                     device=device),
            "goffs_dev": torch.tensor(
                [goffs[k] for k in BLOCK_PARAM_KEYS] + [soffs[-1]],
                dtype=torch.int32, device=device)}
    return _LAYOUTS[key]


_LAYOUTS: Dict = {}


def _check(x: torch.Tensor, bias: torch.Tensor, masks_xfeat: torch.Tensor,
           params: Sequence[torch.Tensor], num_heads: int) -> None:
    b, j, c = x.shape
    check_width(c, num_heads)
    if (not 1 <= j <= JOINTS_MAX or bias.shape != (HEADS, j, j)
            or masks_xfeat.shape[-2:] != (j, j)):
        raise ValueError(f"gat_trunk_train kernels take 1..{JOINTS_MAX} "
                         f"joints: x {tuple(x.shape)}, bias "
                         f"{tuple(bias.shape)}")
    shapes = _layout(j, c, "cpu")["shapes"]
    for name, t in zip(BLOCK_PARAM_KEYS, params):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"gat_trunk_train: {name} is "
                             f"{tuple(t.shape)}, x {tuple(x.shape)} needs "
                             f"{shapes[name]}")
    cuda_lib.kernel_dtype(x.dtype)
    for t in (bias, masks_xfeat, *params):
        if t.device != x.device:
            raise ValueError("gat_trunk_train: all tensors must be on x's "
                             "device")


class GatBlockTrain(torch.autograd.Function):
    """One block on the K5 kernels: forward `gat_block_fwd` (which also
    saves, per row, the operands the backward reads: `ops` in x's dtype and
    x1 in f32), backward `gat_block_bwd` (dx, the weight gradients'
    cotangent operands, each tile's small gradients), `gat_block_wgrad`
    and the two fixed-order reductions. Inputs: x [B, J, C] (C = 128 or
    64, `gat_trunk.WIDTHS`; f32 or bf16), the hop/path bias [8, J, J]
    (gets a gradient), the XFeat masks
    [2, J, J] (constants), a `BlockCfg`, an optional dict that receives the
    exported masks, then the 25 parameters in BLOCK_PARAM_KEYS order. The
    output and dx are in x's dtype, as the JAX kernel writes them
    (pallas_gat_train.py:350): a bf16 stream is rounded at each block
    boundary; dbias and the parameter gradients are f32."""

    @staticmethod
    def forward(ctx, x, bias, masks_xfeat, cfg: BlockCfg, export, *params):
        _check(x, bias, masks_xfeat, params, cfg.num_heads)
        b, j, c = x.shape
        lay = _layout(j, c, x.device)
        lib = cuda_lib.load("gat_trunk_train", _SIGNATURE)
        x = x.contiguous()
        bias32 = bias.detach().float().contiguous()
        xm = masks_xfeat.detach().float()[:2].contiguous()
        w = cuda_lib.pack_fields(params, lay["offsets"], lay["wstride"],
                                 x.dtype)
        out = torch.empty_like(x)
        ops = torch.empty(b * j, lib.gat_block_train_op_cols(c),
                          dtype=x.dtype, device=x.device)
        x1s = torch.empty(b * j, c, dtype=torch.float32, device=x.device)
        mask_buf = None
        if export is not None:
            mask_buf = torch.empty(
                b * (HEADS * j * j + 2 * j * c + j * 4 * c + 2),
                dtype=torch.float32, device=x.device)
        if b > 0:
            plan = launch_plan(b, j)
            err = lib.gat_block_train_fwd(
                cuda_lib.kernel_dtype(x.dtype), c, x.data_ptr(),
                bias32.data_ptr(), xm.data_ptr(), w.data_ptr(),
                lay["offs_dev"].data_ptr(), out.data_ptr(), ops.data_ptr(),
                x1s.data_ptr(),
                None if mask_buf is None else mask_buf.data_ptr(), b, j,
                plan["g"], plan["ntiles"], cfg.seed, cfg.unit, cfg.sample0,
                *cfg.rate_args(), cuda_lib.stream_ptr(x))
            cuda_lib.check(err, "gat_block_train_fwd")
            gat_trunk_train.launches_fwd += 1
        if export is not None:
            export.update(_split_masks(mask_buf, b, j, c))
        ctx.cfg = cfg
        ctx.save_for_backward(x, bias32, xm, w, ops, x1s, *params)
        return out

    @staticmethod
    def backward(ctx, gout):
        cfg = ctx.cfg
        x, bias32, xm, w, ops, x1s, *params = ctx.saved_tensors
        b, j, c = x.shape
        lay = _layout(j, c, x.device)
        lib = cuda_lib.load("gat_trunk_train", _SIGNATURE)
        gout = gout.to(x.dtype).contiguous()
        dx = torch.empty_like(x)
        f32 = dict(dtype=torch.float32, device=x.device)
        alloc = torch.empty if b > 0 else torch.zeros
        wgrads = alloc(lay["gwstride"], **f32)
        sgrads = alloc(lay["gsstride"], **f32)
        if b > 0:
            plan = launch_plan(b, j)
            spart = torch.empty(plan["ntiles"], lay["gsstride"], **f32)
            wpart = torch.empty(plan["nc_w"], lay["gwstride"], **f32)
            err = lib.gat_block_train_bwd(
                cuda_lib.kernel_dtype(x.dtype), c, x.data_ptr(),
                bias32.data_ptr(), xm.data_ptr(), w.data_ptr(),
                lay["offs_dev"].data_ptr(), lay["goffs_dev"].data_ptr(),
                gout.data_ptr(), ops.data_ptr(), x1s.data_ptr(),
                dx.data_ptr(), spart.data_ptr(), lay["gsstride"],
                wpart.data_ptr(), lay["gwstride"], sgrads.data_ptr(),
                wgrads.data_ptr(), b, j, plan["g"], plan["ntiles"],
                plan["nc_w"], plan["wper"], cfg.seed, cfg.unit, cfg.sample0,
                *cfg.rate_args(), cuda_lib.stream_ptr(x))
            cuda_lib.check(err, "gat_block_train_bwd")
            gat_trunk_train.launches_bwd += 4
        dparams = []
        for name, p in zip(BLOCK_PARAM_KEYS, params):
            src = wgrads if name in WEIGHT_KEYS else sgrads
            off = lay["goffs"][name]
            dparams.append(src[off:off + p.numel()].view(p.shape).to(
                p.dtype))
        hop = lay["hop"]
        dbias = sgrads[hop:hop + HEADS * j * j].view(HEADS, j, j)
        return (dx, dbias, None, None, None, *dparams)


def _split_masks(buf: torch.Tensor, b: int, j: int,
                 c: int) -> Dict[str, torch.Tensor]:
    sizes = [("attn", (b, HEADS, j, j)), ("proj", (b, j, c)),
             ("dp1", (b, 1, 1)), ("mlp1", (b, j, 4 * c)),
             ("mlp2", (b, j, c)), ("dp2", (b, 1, 1))]
    out, pos = {}, 0
    for name, shape in sizes:
        n = int(np.prod(shape))
        out[name] = buf[pos:pos + n].view(shape)
        pos += n
    return out


def _trunk(x, bias, block_params, masks_xfeat, num_heads, seed, attn_rate,
           proj_rate, mlp_rate, drop_path_rate, export, sample0: int,
           kernel: bool):
    depth = len(block_params)
    dpr = np.linspace(0.0, drop_path_rate, depth)
    b, j, c = x.shape
    xm = torch.as_tensor(masks_xfeat, dtype=torch.float32,
                         device=x.device)
    for bi, bp in enumerate(block_params):
        cfg = BlockCfg(num_heads=num_heads, block=bi, seed=int(seed),
                       attn_rate=attn_rate, proj_rate=proj_rate,
                       mlp_rate=mlp_rate, path_rate=float(dpr[bi]),
                       sample0=int(sample0))
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
                        export: Optional[List[Dict]] = None,
                        sample0: int = 0) -> torch.Tensor:
    """The trunk on the plain version, on any device, with the masks the
    kernels draw (the plain path of the train steps)."""
    return _trunk(x, bias, block_params, masks_xfeat, num_heads, seed,
                  attn_rate, proj_rate, mlp_rate, drop_path_rate, export,
                  sample0, kernel=False)


def gat_trunk_train(x: torch.Tensor, bias: torch.Tensor,
                    block_params: Sequence[Dict[str, torch.Tensor]],
                    masks_xfeat, num_heads: int, seed: int,
                    attn_rate: float = 0.4, proj_rate: float = 0.4,
                    mlp_rate: float = 0.1, drop_path_rate: float = 0.2,
                    export: Optional[List[Dict]] = None,
                    sample0: int = 0) -> torch.Tensor:
    """The lifter trunk in training mode (gator_tpu/nn/pallas_gat_train.py
    :530): one `GatBlockTrain` per block on a CUDA tensor, the plain
    version with the hash's masks on a CPU tensor (no fallback between
    them). DropPath rates are linspace(0, drop_path_rate, depth). bias:
    [H, J, J] (differentiable); masks_xfeat: [2, J, J] constants. With
    `export` (a list), each block's masks are appended to it: those the
    kernel exported, or those the plain version used. sample0: the global
    index of x's first sample, which keys its masks (a data-parallel rank
    passes rank * b; 0 on one device)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"gat_trunk_train: unsupported device {x.device}")
    return _trunk(x, bias, block_params, masks_xfeat, num_heads, seed,
                  attn_rate, proj_rate, mlp_rate, drop_path_rate, export,
                  sample0, kernel=x.device.type == "cuda")


# launches of the CUDA kernels (forward and backward apart); the CPU path
# never counts
gat_trunk_train.launches_fwd = 0
gat_trunk_train.launches_bwd = 0
