"""T1: the LBF layer with pieces removed or changed, for timing ablations.

`run_layers` runs the hand-written CUDA kernels of `csrc/lbf_ablate.cu` on
a CUDA tensor and the plain PyTorch version `run_layers_ref` on a CPU
tensor. It replaces tools/exp_mdr_ablate.py:199 `run_layers` (kernel body
`_kernel:49`), which `python -m gator_tpu_torch.tools.exp_mdr_ablate`
drives.

T1 rounds unlike K2-layer (`lbf_layer`): products come out in f32 and an
operand is cast to the working dtype T where it enters a product (q, k, v
per head, the probabilities, the head outputs, the MLP hidden); each
head's output goes through its own rows of `proj_w` or `l3_w` and the
head results are summed in f32; biases are added in f32; the std-LN
output stays f32 for the residual; each layer's output is T.

The modes (`MODES`, in the order of `enum Mode` in csrc/lbf_layer.cuh),
against `full` (`_kernel:173-196`):
  lnonly    y3 = StdLN(LN1(x)), out = y3 + LN2(y3): no product, no joints;
  mlponly   out = x + fc2(gelu(fc1(T(LN2 x))));
  nocross   no cross-attention: x1 = x + proj_b;
  nomlp     the MLP hidden is zero, so it adds fc2_b;
  nogelu    identity activation;  tanhgelu  the tanh-form GELU;
  bf16gelu  GELU of T(pre), rounded to T;
  noself    out = y3 + l3_b;
  preproj   out = y3 + sum_h prob_h T((T(v2) l3_w) / H) + l3_b (what
            `_kernel:126-148` computes, which is not the layer's math);
  fold1dot  both heads' prob @ (T(v2_h) l3_w[h rows]) in one f32 sum;
  bf16smax  the softmax of T(s * scale) computed in T;
  nosoftmax prob = T(s * scale / 431), no softmax, over the Nv real keys
            (the TPU kernel's pad key row at Nv=431 is not reproduced).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from . import cuda_lib
from .layers import layer_norm32, std_layer_norm
from .lbf_layer import EMBED, HEADS, check_layer_args

MODES = ("full", "lnonly", "mlponly", "nocross", "nomlp", "nogelu",
         "tanhgelu", "bf16gelu", "noself", "preproj", "fold1dot", "bf16smax",
         "nosoftmax")
# modes whose layer is row-local: one launch, no self-attention
ROW_MODES = ("lnonly", "mlponly", "noself")

_SIGNATURE = {
    "lbf_ablate_rows_launch": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "lbf_ablate_attn_launch": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


def _check(b: int, group: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"run_layers: unknown mode {mode!r}; modes are "
                         f"{', '.join(MODES)}")
    if group < 1 or b % group:
        raise ValueError(f"run_layers: batch {b} is not a multiple of "
                         f"group {group}")


def _layer_ref(x, jf, p, num_heads: int, dt: torch.dtype, mode: str):
    """One layer of `mode` on f32 x [B, Nv, C] and joints jf [B, J, C]
    (values of dt) -> [B, Nv, C] in dt."""
    def rnd(t):
        return t.to(dt).float()

    def heads(t):
        b, n, c = t.shape
        return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)

    def merge(t):
        b, h, n, d = t.shape
        return t.transpose(1, 2).reshape(b, n, h * d)

    def linear(t, name):
        return t @ p[name + "_w"] + p[name + "_b"]

    c = x.shape[-1]
    d = c // num_heads
    scale = d ** -0.5
    if mode == "lnonly":
        y3 = std_layer_norm(layer_norm32(x, p["ln1_w"], p["ln1_b"]), p["a2"],
                            p["b2"])
        return (y3 + layer_norm32(y3, p["ln2_w"], p["ln2_b"])).to(dt)
    if mode == "mlponly":
        y2 = rnd(layer_norm32(x, p["ln2_w"], p["ln2_b"]))
        return (x + linear(rnd(F.gelu(linear(y2, "fc1"))), "fc2")).to(dt)
    if mode == "nocross":
        x1 = x + p["proj_b"]
    else:
        yv = rnd(layer_norm32(x, p["ln1_w"], p["ln1_b"]))
        yj = rnd(layer_norm32(jf, p["ln1_w"], p["ln1_b"]))
        q, k, v = (heads(rnd(y @ p[w])) for y, w in
                   ((yv, "wq"), (yj, "wk"), (yj, "wv")))
        prob = rnd(torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1))
        x1 = x + (merge(rnd(prob @ v)) @ p["proj_w"] + p["proj_b"])

    pre = linear(rnd(layer_norm32(x1, p["ln2_w"], p["ln2_b"])), "fc1")
    if mode == "nomlp":
        x2 = x1 + p["fc2_b"]
    else:
        if mode == "nogelu":
            m = pre
        elif mode == "tanhgelu":
            m = 0.5 * pre * (1.0 + torch.tanh(0.7978845608028654 * (
                pre + 0.044715 * (pre * pre * pre))))
        elif mode == "bf16gelu":
            m = rnd(F.gelu(rnd(pre)))
        else:
            m = F.gelu(pre)
        x2 = x1 + linear(rnd(m), "fc2")

    y3 = std_layer_norm(x2, p["a2"], p["b2"])
    if mode == "noself":
        return (y3 + p["l3_b"]).to(dt)
    y3d = rnd(y3)
    q2, k2 = (heads(rnd(linear(y3d, f"l{i}"))) for i in (0, 1))
    v2 = rnd(linear(y3d, "l2"))
    s = q2 @ k2.transpose(-1, -2)
    if mode == "bf16smax":
        st = rnd(s * scale)
        e = rnd(torch.exp(rnd(st - st.amax(-1, keepdim=True))))
        prob = rnd(e / rnd(e.sum(-1, keepdim=True)))
    elif mode == "nosoftmax":
        prob = rnd(s * (scale / 431.0))
    else:
        prob = rnd(torch.softmax(s * scale, dim=-1))
    if mode == "preproj":
        vp = rnd((v2 @ p["l3_w"]) * (1.0 / num_heads))       # [B, Nv, C]
        sa = (prob @ vp[:, None]).sum(1)
    elif mode == "fold1dot":
        l3h = p["l3_w"].reshape(num_heads, d, c)
        sa = (prob @ rnd(heads(v2) @ l3h)).sum(1)
    else:
        sa = merge(rnd(prob @ heads(v2))) @ p["l3_w"]
    return (y3 + sa + p["l3_b"]).to(dt)


def run_layers_ref(verts: torch.Tensor, joints: torch.Tensor,
                   layers: Sequence[cuda_lib.Packed], num_heads: int,
                   group: int, mode: str) -> torch.Tensor:
    """Plain PyTorch version of every mode: verts [B, Nv, C], joints
    [B, J, C] in the weights' dtype, one packed weight set per layer."""
    _check(verts.shape[0], group, mode)
    x = verts
    for w in layers:
        p = {k: v.float() for k, v in w.layers[0].items()}
        x = _layer_ref(x.float(), joints.float(), p, num_heads, w.dtype,
                       mode)
    return x


def run_layers_cuda(verts: torch.Tensor, joints: torch.Tensor,
                    layers: Sequence[cuda_lib.Packed],
                    mode: str) -> torch.Tensor:
    """Launch csrc/lbf_ablate.cu per layer: the row-local kernel, then,
    unless `mode` is row-local, the self-attention."""
    for w in layers:
        check_layer_args("run_layers", verts, joints, w)
    b, nv, c = verts.shape
    if b == 0 or nv == 0 or not layers:
        return verts.clone()
    lib = cuda_lib.load("lbf_ablate", _SIGNATURE)
    code = cuda_lib.kernel_dtype(verts.dtype)
    m = MODES.index(mode)
    stream = cuda_lib.stream_ptr(verts)
    x, joints = verts.contiguous(), joints.contiguous()
    y3 = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    q2, k2 = torch.empty_like(x), torch.empty_like(x)
    # V of the self-attention: l2's output, or (preproj) the full-width
    # pre-projected rows, or (fold1dot) one projected row per head
    vbuf = torch.empty(b, nv, HEADS * c if mode == "fold1dot" else c,
                       dtype=x.dtype, device=x.device)
    for w in layers:
        out = torch.empty_like(x)
        layer, offs = w.flat.data_ptr(), w.offsets.data_ptr()
        err = lib.lbf_ablate_rows_launch(
            code, m, x.data_ptr(), joints.data_ptr(), layer, offs,
            y3.data_ptr(), q2.data_ptr(), k2.data_ptr(), vbuf.data_ptr(),
            out.data_ptr(), b, nv, joints.shape[1], stream)
        cuda_lib.check(err, "lbf_ablate_rows_launch")
        run_layers.launches += 1
        if mode not in ROW_MODES:
            err = lib.lbf_ablate_attn_launch(
                code, m, q2.data_ptr(), k2.data_ptr(), vbuf.data_ptr(),
                y3.data_ptr(), layer, offs, out.data_ptr(), b, nv, stream)
            cuda_lib.check(err, "lbf_ablate_attn_launch")
            run_layers.launches += 1
        x = out
    return x


def run_layers(verts: torch.Tensor, joints: torch.Tensor,
               layers: Sequence[cuda_lib.Packed], num_heads: int, group: int,
               mode: str) -> torch.Tensor:
    """The layers of `layers` (one packed weight set each) in `mode`: the
    CUDA kernels for a CUDA tensor, the plain version for a CPU tensor.

    `group` is the TPU kernel's sample tile (`b // group` grid programs),
    kept for the signature; the CUDA tiling does not depend on it. The
    batch must be a multiple of it: the TPU grid leaves the remainder
    unwritten, so the port refuses such a batch."""
    _check(verts.shape[0], group, mode)
    if verts.device.type == "cuda":
        if num_heads != HEADS or verts.shape[-1] != EMBED:
            raise ValueError(f"run_layers kernels take {HEADS} heads and "
                             f"C={EMBED}")
        return run_layers_cuda(verts, joints, layers, mode)
    if verts.device.type == "cpu":
        return run_layers_ref(verts, joints, layers, num_heads, group, mode)
    raise ValueError(f"run_layers: unsupported device {verts.device}")


# launches of the CUDA kernels (one or two per layer); the CPU path never
# counts
run_layers.launches = 0
