"""K4: the MDR LBF layer in training mode (dropout at six sites,
hand-derived backward), counterpart of gator_tpu/nn/pallas_mdr_train.py.

`lbf_stack_train` runs each layer as `LbfLayerTrain`, an autograd Function
whose forward and backward are the hand-written CUDA kernels of
`csrc/lbf_stack_train.cu`, on a CUDA tensor; on a CPU tensor it runs the
plain version `lbf_layer_train_ref` with the same masks (from
`dropout_masks`) under torch autograd. It replaces
gator_tpu/nn/pallas_mdr_train.py:592 `lbf_stack_train`.

Parameters are the 23 tensors of `LAYER_PARAM_KEYS`, taken from the MDR
module by `extract_layer_params` (linear weights transposed to [in, out],
differentiable), packed (detached) inside the Function's forward, which
returns one gradient per input.

What the Function saves differs from the JAX custom VJP (which keeps only
the layer input and recomputes everything): besides the input it keeps the
self-attention's q2/k2/v2, its output a2 and the per-row log-sum-exp (a few
MB per layer), so that the backward recomputes the [431, 431] probabilities
tile by tile instead of holding them. The result is the same function.

Dtypes, as the JAX kernel: the layer output, dx and djoints are in the
input's dtype (a bf16 stream is rounded at each layer boundary), every
matmul rounds its operands to that dtype and accumulates in f32; the
self-attention probabilities stay f32 (an online softmax never holds them
normalised, as in K2); parameter gradients are f32.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_lib
from .dropout_masks import (M_ATTN0, M_DP1, M_DP2, M_MLP1, M_MLP2, M_OUT,
                            M_PROJ, M_SELF0, keep_mask, keep_scale,
                            threshold)
from .layers import std_layer_norm

# parameter keys of one LBF layer, in the kernel's field order (`enum
# Field` in csrc/lbf_stack_train.cu); gator_tpu/nn/pallas_mdr.py:35
LAYER_PARAM_KEYS = (
    "norm1_scale", "norm1_bias",
    "wq", "wk", "wv", "proj_w", "proj_b",
    "norm2_scale", "norm2_bias",
    "fc1_w", "fc1_b", "fc2_w", "fc2_b",
    "a2", "b2",
    "l0_w", "l0_b", "l1_w", "l1_b", "l2_w", "l2_b", "l3_w", "l3_b",
)

# (attn, proj, path, mlp, self_attn, out): the flax model's defaults
# (gator_tpu/nn/pallas_mdr_train.py:53-54)
DEFAULT_RATES = (0.2, 0.2, 0.2, 0.2, 0.1, 0.1)
ZERO_RATES = (0.0,) * 6

EMBED, HEADS, HIDDEN, JOINTS_MAX = 64, 2, 256, 32
ROW_TILE = 32                # vertex rows per rows-kernel tile
NCTA_MAX = 264               # grid of the grid-stride kernels

_RATE_ARGS = [ctypes.c_uint, ctypes.c_float] * 6
_SIGNATURE = {
    "lbf_train_scratch": [],
    "lbf_train_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 13
    + [ctypes.c_int] * 4 + [ctypes.c_uint, ctypes.c_int] + _RATE_ARGS
    + [ctypes.c_void_p],
    "lbf_train_bwd": [ctypes.c_int] + [ctypes.c_void_p] * 21
    + [ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 7
    + [ctypes.c_uint, ctypes.c_int] + _RATE_ARGS + [ctypes.c_void_p],
}


def extract_layer_params(mdr, layer: int) -> Dict[str, torch.Tensor]:
    """One LBF layer's parameters in `LAYER_PARAM_KEYS` form, linear
    weights as [in, out] (differentiable views; gator_tpu/nn/pallas_mdr.py
    :455 `extract_layer_params`)."""
    enc, norm, sa = mdr.lbf_layers()[layer]
    lin = sa.linears
    out = {
        "norm1_scale": enc.norm1.weight, "norm1_bias": enc.norm1.bias,
        "wq": enc.attn.wq.weight.T, "wk": enc.attn.wk.weight.T,
        "wv": enc.attn.wv.weight.T,
        "proj_w": enc.attn.proj.weight.T, "proj_b": enc.attn.proj.bias,
        "norm2_scale": enc.norm2.weight, "norm2_bias": enc.norm2.bias,
        "fc1_w": enc.mlp.fc1.weight.T, "fc1_b": enc.mlp.fc1.bias,
        "fc2_w": enc.mlp.fc2.weight.T, "fc2_b": enc.mlp.fc2.bias,
        "a2": norm.a_2, "b2": norm.b_2,
    }
    for i in range(4):
        out[f"l{i}_w"] = lin[i].weight.T
        out[f"l{i}_b"] = lin[i].bias
    return out


@dataclasses.dataclass(frozen=True)
class LayerCfg:
    """One layer's dropout configuration (gator_tpu TrainLayerCfg)."""

    num_heads: int
    layer: int
    seed: int
    rates: tuple = DEFAULT_RATES

    def rate_args(self) -> list:
        out = []
        for rate in self.rates:
            out += [threshold(rate), keep_scale(rate)]
        return out


def layer_masks(cfg: LayerCfg, batch: int, nv: int, nj: int, c: int,
                device=None) -> Dict[str, Optional[torch.Tensor]]:
    """The masks the kernels draw for one layer, as the explicit-mask
    arrays of `lbf_layer_train_ref`: attn [B,H,Nv,J], proj [B,Nv,C],
    dp1/dp2 [B,1,1], mlp1 [B,Nv,4C], mlp2 [B,Nv,C], self [B,H,Nv,Nv],
    out [B,Nv,C] (None at rate 0)."""
    r_attn, r_proj, r_path, r_mlp, r_self, r_out = cfg.rates
    s, u, h = cfg.seed, cfg.layer, cfg.num_heads

    def heads(mid0, rate, shape):
        got = [keep_mask(s, u, mid0 + i, rate, batch, shape, device)
               for i in range(h)]
        return None if got[0] is None else torch.stack(got, 1)

    return {
        "attn": heads(M_ATTN0, r_attn, (nv, nj)),
        "proj": keep_mask(s, u, M_PROJ, r_proj, batch, (nv, c), device),
        "dp1": keep_mask(s, u, M_DP1, r_path, batch, (1, 1), device),
        "mlp1": keep_mask(s, u, M_MLP1, r_mlp, batch, (nv, 4 * c), device),
        "mlp2": keep_mask(s, u, M_MLP2, r_mlp, batch, (nv, c), device),
        "dp2": keep_mask(s, u, M_DP2, r_path, batch, (1, 1), device),
        "self": heads(M_SELF0, r_self, (nv, nv)),
        "out": keep_mask(s, u, M_OUT, r_out, batch, (nv, c), device),
    }


def _ap(t: torch.Tensor, m: Optional[torch.Tensor]) -> torch.Tensor:
    return t if m is None else t * m


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, h, c // h).transpose(1, 2)      # [B, H, N, D]


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def lbf_layer_train_ref(x: torch.Tensor, jt: torch.Tensor,
                        p: Dict[str, torch.Tensor],
                        masks: Dict[str, Optional[torch.Tensor]],
                        num_heads: int) -> torch.Tensor:
    """Plain version of one training layer with explicit scaled masks
    (gator_tpu/nn/pallas_mdr_train.py:614 `lbf_layer_train_ref`), batched:
    x [B, Nv, C], jt [B, J, C], masks as `layer_masks`. Matmul operands
    are rounded to x's dtype, as the kernels round them (the self-attention
    probabilities stay f32, as the kernels keep them)."""
    dt = x.dtype

    def r(t):
        return t.to(dt).float()

    h = num_heads
    scale = (x.shape[-1] // h) ** -0.5
    p = {k: r(v) for k, v in p.items()}   # the kernels pack them in dt
    m = masks.get
    x32, j32 = x.float(), jt.float()

    def ln(t, w, b):
        return F.layer_norm(t, t.shape[-1:], w, b, 1e-5)

    yv = ln(x32, p["norm1_scale"], p["norm1_bias"])
    yj = ln(j32, p["norm1_scale"], p["norm1_bias"])
    q = _heads(r(yv) @ p["wq"], h)
    k = _heads(r(yj) @ p["wk"], h)
    v = _heads(r(yj) @ p["wv"], h)
    prob = torch.softmax(r(q) @ r(k).transpose(-1, -2) * scale, dim=-1)
    a1 = _merge(r(_ap(prob, m("attn"))) @ r(v))
    o = _ap(r(a1) @ p["proj_w"] + p["proj_b"], m("proj"))
    x1 = x32 + _ap(o, m("dp1"))
    y2 = ln(x1, p["norm2_scale"], p["norm2_bias"])
    h1 = _ap(F.gelu(r(y2) @ p["fc1_w"] + p["fc1_b"]), m("mlp1"))
    h2 = _ap(r(h1) @ p["fc2_w"] + p["fc2_b"], m("mlp2"))
    x2 = x1 + _ap(h2, m("dp2"))
    y3 = std_layer_norm(x2, p["a2"], p["b2"])
    q2, k2, v2 = (_heads(r(y3) @ p[f"l{i}_w"] + p[f"l{i}_b"], h)
                  for i in range(3))
    prob2 = torch.softmax(r(q2) @ r(k2).transpose(-1, -2) * scale, dim=-1)
    a2 = _merge(_ap(prob2, m("self")) @ r(v2))
    sa = r(a2) @ p["l3_w"] + p["l3_b"]
    return (y3 + _ap(sa, m("out"))).to(dt)


# --- the CUDA path ---------------------------------------------------------

_LAYOUTS: Dict = {}


def _layout(device) -> Dict:
    key = str(device)
    if key not in _LAYOUTS:
        c, hid = EMBED, HIDDEN
        sizes = {"wq": c * c, "wk": c * c, "wv": c * c, "proj_w": c * c,
                 "fc1_w": c * hid, "fc1_b": hid, "fc2_w": hid * c,
                 **{f"l{i}_w": c * c for i in range(4)}}
        offsets, stride = cuda_lib.field_offsets(
            sizes.get(name, c) for name in LAYER_PARAM_KEYS)
        _LAYOUTS[key] = {"offsets": offsets, "stride": stride,
                         "offs_dev": torch.tensor(offsets, dtype=torch.int32,
                                                  device=device)}
    return _LAYOUTS[key]


def _check(x, jt, params, num_heads):
    b, nv, c = x.shape
    if (c != EMBED or num_heads != HEADS or jt.shape[0] != b
            or jt.shape[2] != c or not 1 <= jt.shape[1] <= JOINTS_MAX):
        raise ValueError(f"lbf_stack_train kernels take C={EMBED}, {HEADS} "
                         f"heads and 1..{JOINTS_MAX} joints: x "
                         f"{tuple(x.shape)}, joints {tuple(jt.shape)}")
    if x.dtype != jt.dtype:
        raise TypeError(f"x is {x.dtype}, joints are {jt.dtype}")
    cuda_lib.kernel_dtype(x.dtype)
    if b > 65535:
        raise ValueError("lbf_stack_train kernels take at most 65535 samples")
    for t in (jt, *params):
        if t.device != x.device:
            raise ValueError("lbf_stack_train: all tensors must be on x's "
                             "device")


def _ncta(n: int) -> int:
    return max(1, min(n, NCTA_MAX))


class LbfLayerTrain(torch.autograd.Function):
    """One layer on the K4 kernels: forward `lbf_train_fwd` (row-local
    launch, then the flash-style self-attention), backward
    `lbf_train_bwd` (five launches and the reduction of the per-CTA
    gradient partials). Inputs: x [B, Nv, 64], joints [B, J, 64] (f32 or
    bf16, one dtype), a `LayerCfg`, an optional dict that receives the
    exported masks, then the 23 parameters in LAYER_PARAM_KEYS order. The
    output, dx and djoints are in the input's dtype, as the JAX kernel
    writes them (pallas_mdr_train.py:417): a bf16 stream is rounded at
    each layer boundary; the parameter gradients are f32."""

    @staticmethod
    def forward(ctx, x, jt, cfg: LayerCfg, export, *params):
        _check(x, jt, params, cfg.num_heads)
        b, nv, c = x.shape
        nj = jt.shape[1]
        lay = _layout(x.device)
        lib = cuda_lib.load("lbf_stack_train", _SIGNATURE)
        x, jt = x.contiguous(), jt.contiguous()
        w = cuda_lib.pack_fields(params, lay["offsets"], lay["stride"],
                                 x.dtype)
        f32 = dict(dtype=torch.float32, device=x.device)
        out = torch.empty_like(x)
        y3, q2, k2, v2, a2 = (torch.empty(b, nv, c, **f32) for _ in range(5))
        lse = torch.empty(b, HEADS, nv, **f32)
        mask_buf = None
        if export is not None:
            mask_buf = torch.empty(
                b * (HEADS * nv * nj + 3 * nv * c + nv * HIDDEN + 2
                     + HEADS * nv * nv), **f32)
        if b > 0 and nv > 0:
            ntiles = -(-nv // ROW_TILE)
            nctas = _ncta(b * ntiles)
            scratch = torch.empty(nctas * lib.lbf_train_scratch(), **f32)
            err = lib.lbf_train_fwd(
                cuda_lib.kernel_dtype(x.dtype), x.data_ptr(), jt.data_ptr(),
                w.data_ptr(), lay["offs_dev"].data_ptr(), out.data_ptr(),
                y3.data_ptr(), q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
                a2.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                None if mask_buf is None else mask_buf.data_ptr(), b, nv, nj,
                nctas, cfg.seed, cfg.layer, *cfg.rate_args(),
                cuda_lib.stream_ptr(x))
            cuda_lib.check(err, "lbf_train_fwd")
            lbf_stack_train.launches_fwd += 2
        if export is not None:
            export.update(_split_masks(mask_buf, b, nv, nj, c))
        ctx.cfg = cfg
        ctx.save_for_backward(x, jt, w, q2, k2, v2, a2, lse, *params)
        return out

    @staticmethod
    def backward(ctx, gout):
        cfg = ctx.cfg
        x, jt, w, q2, k2, v2, a2, lse, *params = ctx.saved_tensors
        b, nv, c = x.shape
        nj = jt.shape[1]
        lay = _layout(x.device)
        lib = cuda_lib.load("lbf_stack_train", _SIGNATURE)
        gout = gout.to(x.dtype).contiguous()
        dx, djt = torch.empty_like(x), torch.empty_like(jt)
        f32 = dict(dtype=torch.float32, device=x.device)
        grads = torch.zeros(lay["stride"], **f32)
        if b > 0 and nv > 0:
            ntiles = -(-nv // ROW_TILE)
            nc_out = nc_rows = _ncta(b * ntiles)
            nc_j = _ncta(b)
            da2, dq2, dk2, dv2 = (torch.empty(b, nv, c, **f32)
                                  for _ in range(4))
            dd = torch.empty(b, HEADS, nv, **f32)
            djk, djv = (torch.empty(b, ntiles, nj, c, **f32)
                        for _ in range(2))
            scratch = torch.empty(max(nc_rows, nc_j)
                                  * lib.lbf_train_scratch(), **f32)
            part = torch.zeros(nc_out + nc_rows + nc_j, lay["stride"], **f32)
            err = lib.lbf_train_bwd(
                cuda_lib.kernel_dtype(x.dtype), x.data_ptr(), jt.data_ptr(),
                w.data_ptr(), lay["offs_dev"].data_ptr(), gout.data_ptr(),
                q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), a2.data_ptr(),
                lse.data_ptr(), dx.data_ptr(), djt.data_ptr(),
                da2.data_ptr(), dd.data_ptr(), dq2.data_ptr(),
                dk2.data_ptr(), dv2.data_ptr(), djk.data_ptr(),
                djv.data_ptr(), scratch.data_ptr(), part.data_ptr(),
                lay["stride"], grads.data_ptr(), lay["stride"], b, nv, nj,
                nc_out, nc_rows, nc_j, cfg.seed, cfg.layer,
                *cfg.rate_args(), cuda_lib.stream_ptr(x))
            cuda_lib.check(err, "lbf_train_bwd")
            lbf_stack_train.launches_bwd += 6
        dparams = [grads[off:off + p.numel()].view(p.shape).to(p.dtype)
                   for off, p in zip(lay["offsets"], params)]
        return (dx, djt, None, None, *dparams)


def _split_masks(buf: torch.Tensor, b: int, nv: int, nj: int,
                 c: int) -> Dict[str, torch.Tensor]:
    sizes = [("attn", (b, HEADS, nv, nj)), ("proj", (b, nv, c)),
             ("dp1", (b, 1, 1)), ("mlp1", (b, nv, HIDDEN)),
             ("mlp2", (b, nv, c)), ("dp2", (b, 1, 1)),
             ("self", (b, HEADS, nv, nv)), ("out", (b, nv, c))]
    out, pos = {}, 0
    for name, shape in sizes:
        n = int(np.prod(shape))
        out[name] = buf[pos:pos + n].view(shape)
        pos += n
    return out


def _stack(x, jt, layer_params, num_heads, seed, rates, export, kernel):
    b, nv, c = x.shape
    for li, lp in enumerate(layer_params):
        cfg = LayerCfg(num_heads=num_heads, layer=li, seed=int(seed),
                       rates=tuple(float(r) for r in rates))
        if kernel:
            got = None if export is None else {}
            x = LbfLayerTrain.apply(x, jt, cfg, got,
                                    *[lp[k] for k in LAYER_PARAM_KEYS])
        else:
            got = layer_masks(cfg, b, nv, jt.shape[1], c, x.device)
            x = lbf_layer_train_ref(x, jt, lp, got, num_heads)
        if export is not None:
            export.append(got)
    return x


def lbf_stack_train_ref(x: torch.Tensor, jt: torch.Tensor,
                        layer_params: Sequence[Dict[str, torch.Tensor]],
                        num_heads: int, seed: int, rates=DEFAULT_RATES,
                        export: Optional[List[Dict]] = None) -> torch.Tensor:
    """The stack on the plain version, on any device, with the masks the
    kernels draw (the plain path of the train steps)."""
    return _stack(x, jt, layer_params, num_heads, seed, rates, export,
                  kernel=False)


def lbf_stack_train(x: torch.Tensor, jt: torch.Tensor,
                    layer_params: Sequence[Dict[str, torch.Tensor]],
                    num_heads: int, seed: int, rates=DEFAULT_RATES,
                    export: Optional[List[Dict]] = None) -> torch.Tensor:
    """The LBF stack in training mode (gator_tpu/nn/pallas_mdr_train.py
    :592): one `LbfLayerTrain` per layer on a CUDA tensor, the plain
    version with the hash's masks on a CPU tensor (no fallback between
    them). jt feeds every layer; its gradient sums over the layers through
    autograd. With `export` (a list), each layer's masks are appended."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"lbf_stack_train: unsupported device {x.device}")
    return _stack(x, jt, layer_params, num_heads, seed, rates, export,
                  kernel=x.device.type == "cuda")


# launches of the CUDA kernels (forward and backward apart); the CPU path
# never counts
lbf_stack_train.launches_fwd = 0
lbf_stack_train.launches_bwd = 0
