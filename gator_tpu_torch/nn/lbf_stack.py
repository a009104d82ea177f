"""K2: the MDR LBF stack of the serving path (3 layers, inference only).

`lbf_stack` runs the hand-written CUDA kernels of `csrc/lbf_stack.cu` on a
CUDA tensor and the plain PyTorch version `lbf_stack_ref` on a CPU tensor.
It replaces gator_tpu/nn/pallas_mdr.py:352 `lbf_stack_fused`; the math of
one layer is gator_tpu/nn/pallas_mdr.py:87 `_layer_math` (reference:
lib/models/MDR.py:139-153).

Per layer the kernel path makes two launches, both on the tensor cores:
`lbf_rows` (everything that is local to a vertex row) and `lbf_selfattn`
(the Nv x Nv self-attention, the normalised probabilities rounded to the
working dtype, then L3 and the residual). The C entries pick each launch's
kernel from what they are given and count the launches by kernel. Rows,
by dtype: in bf16 csrc/lbf_rows_wg.cuh's, written for Hopper (weights
resident in shared memory, warpgroups on 64-row tiles, `wgmma`); in f32
csrc/lbf_layer.cuh's, which K2-layer and T1 share (`rows_launches`).
Self-attention: bf16 rows of up to `NV_WG` keys (every GATOR
configuration has 431) take csrc/lbf_selfattn_wg.cuh's kernel, one pass
that computes each score and its exponential once with the key row held
across four warpgroups on `wgmma`; f32, or a longer row, the two-pass
kernel of csrc/lbf_stack.cu on csrc/attn_tc.cuh, shared with K3
(`selfattn_launches`). The residual stream between layers stays f32; the
result is cast to the working dtype once. Any batch size: the rows
launches and the bf16 self-attention have 1-D persistent grids, the
two-pass self-attention launches again past the grid's 65535 samples.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_lib
from .layers import layer_norm32, std_layer_norm
from .lbf_layer import EMBED, HEADS, JOINTS_MAX, extract_layer_params

_ROWS_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]
_SA_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p]
_SIGNATURE = {
    "lbf_rows_launch": _ROWS_ARGS,
    # lbf_layer.cuh's rows kernel in either dtype, for the card tests
    "lbf_rows_shared_launch": _ROWS_ARGS,
    "lbf_rows_launch_counts": [ctypes.c_void_p],
    "lbf_selfattn_launch": _SA_ARGS,
    # the two-pass self-attention in either dtype, for the card tests
    "lbf_selfattn_shared_launch": _SA_ARGS,
    "lbf_selfattn_launch_counts": [ctypes.c_void_p],
    "lbf_stack_plan": [ctypes.c_int] * 2
    + [ctypes.POINTER(ctypes.c_int)] * 2,
}


# the rows kernels, in the order the C entry counts and plans them:
# csrc/lbf_layer.cuh's (f32) and csrc/lbf_rows_wg.cuh's (bf16)
ROWS_KERNELS = ("lbf_layer", "lbf_rows_wg")
# the self-attention kernels, likewise: csrc/lbf_stack.cu's two-pass one
# (f32, and rows longer than NV_WG) and csrc/lbf_selfattn_wg.cuh's (bf16)
SELFATTN_KERNELS = ("two_pass", "lbf_selfattn_wg")
# the longest key row lbf_selfattn_wg.cuh's kernel holds (its NV_WG)
NV_WG = 448


def fold_stack_weights(mdr, dtype: torch.dtype, device) -> cuda_lib.Packed:
    """Pack the LBF layers of an `MDR` module (encoder[_i], norm[_i],
    selfatt[_i]) for the kernels: `extract_layer_params` layer after
    layer, in `STACK_FIELDS` order, linear weights as [in, out]."""
    return cuda_lib.stack([extract_layer_params(mdr, i, dtype, device)
                           for i in range(len(mdr.lbf_layers()))])


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, h, c // h).transpose(1, 2)      # [B, H, N, D]


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def lbf_stack_ref(verts: torch.Tensor, joints: torch.Tensor,
                  weights: cuda_lib.Packed, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernels, rounding to the working dtype
    at the same places: verts [B, Nv, C], joints [B, J, C] (dtype of
    `weights`). Both attentions round their normalised probabilities to
    the working dtype, as the TPU kernel does (gator_tpu/nn/
    pallas_mdr.py:342)."""
    dt = weights.dtype

    def rnd(t):
        return t.to(dt).float()

    h = num_heads
    scale = (verts.shape[-1] // h) ** -0.5
    x = verts.float()
    jf = joints.float()
    for w in weights.layers:
        p = {k: v.float() for k, v in w.items()}
        yj = rnd(layer_norm32(jf, p["ln1_w"], p["ln1_b"]))
        k = _heads(rnd(yj @ p["wk"]), h)
        v = _heads(rnd(yj @ p["wv"]), h)
        q = _heads(rnd(rnd(layer_norm32(x, p["ln1_w"], p["ln1_b"]))
                       @ p["wq"]), h)
        prob = rnd(torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1))
        o = rnd(_merge(prob @ v))
        x = x + o @ p["proj_w"] + p["proj_b"]
        y2 = rnd(layer_norm32(x, p["ln2_w"], p["ln2_b"]))
        hid = rnd(F.gelu(y2 @ p["fc1_w"] + p["fc1_b"]))
        x = x + hid @ p["fc2_w"] + p["fc2_b"]
        y3 = std_layer_norm(x, p["a2"], p["b2"])
        y3d = rnd(y3)
        q2, k2, v2 = (_heads(rnd(y3d @ p[f"l{i}_w"] + p[f"l{i}_b"]), h)
                      for i in range(3))
        prob = rnd(torch.softmax(q2 @ k2.transpose(-1, -2) * scale, dim=-1))
        o = rnd(_merge(prob @ v2))
        x = y3 + o @ p["l3_w"] + p["l3_b"]
    return x.to(dt)


def lbf_stack_cuda(verts: torch.Tensor, joints: torch.Tensor,
                   weights: cuda_lib.Packed) -> torch.Tensor:
    """Launch csrc/lbf_stack.cu (two kernels per layer) on CUDA tensors."""
    b, nv, c = verts.shape
    nj = joints.shape[1]
    if c != EMBED or joints.shape != (b, nj, c) or not 1 <= nj <= JOINTS_MAX:
        raise ValueError(f"lbf_stack kernels take C={EMBED} and 1..."
                         f"{JOINTS_MAX} joints: verts {tuple(verts.shape)}, "
                         f"joints {tuple(joints.shape)}")
    if not verts.dtype == joints.dtype == weights.dtype:
        raise TypeError(f"verts {verts.dtype}, joints {joints.dtype}, "
                        f"weights {weights.dtype} must agree")
    for t in (joints, weights.flat, weights.offsets):
        if t.device != verts.device:
            raise ValueError("lbf_stack: all tensors must be on verts' "
                             "device")
    out = torch.empty_like(verts)
    if b == 0 or nv == 0:
        return out
    lib = cuda_lib.load("lbf_stack", _SIGNATURE)
    code = cuda_lib.kernel_dtype(verts.dtype)
    stream = cuda_lib.stream_ptr(verts)
    joints = joints.contiguous()
    # a fresh f32 copy: the layers ping-pong between x and x_next
    x = verts.to(torch.float32, memory_format=torch.contiguous_format,
                 copy=True)
    x_next = torch.empty_like(x)
    y3 = torch.empty_like(x)
    q2, k2, v2 = (torch.empty_like(verts) for _ in range(3))
    offs = weights.offsets.data_ptr()
    for layer in weights.flat:
        err = lib.lbf_rows_launch(
            code, x.data_ptr(), joints.data_ptr(), layer.data_ptr(), offs,
            y3.data_ptr(), q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), b,
            nv, nj, stream)
        cuda_lib.check(err, "lbf_rows_launch")
        lbf_stack.launches += 1
        err = lib.lbf_selfattn_launch(
            code, q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), y3.data_ptr(),
            layer.data_ptr(), offs, x_next.data_ptr(), b, nv, stream)
        cuda_lib.check(err, "lbf_selfattn_launch")
        lbf_stack.launches += 1
        x, x_next = x_next, x
    return out.copy_(x)


def _counts(entry: str, names) -> dict:
    lib = cuda_lib.load("lbf_stack", _SIGNATURE)
    counts = (ctypes.c_longlong * len(names))()
    cuda_lib.check(getattr(lib, entry)(counts), entry)
    return dict(zip(names, counts))


def rows_launches() -> dict:
    """The rows launches the C entry has made in this process, by the
    kernel it took (`ROWS_KERNELS`)."""
    return _counts("lbf_rows_launch_counts", ROWS_KERNELS)


def selfattn_launches() -> dict:
    """The self-attention launches the C entry has made in this process, by
    the kernel it took (`SELFATTN_KERNELS`)."""
    return _counts("lbf_selfattn_launch_counts", SELFATTN_KERNELS)


def stack_plan(dtype: torch.dtype, nv: int) -> dict:
    """The launches' plan on the current CUDA device at `nv` vertices: the
    self-attention kernel the C entry takes (`SELFATTN_KERNELS`), its keys
    a staged K/V chunk (the bf16 kernel: its whole row, `NV_WG`), CTAs an
    SM, shared bytes, registers a thread and warpgroups a CTA (0 for the
    two-pass kernel); the rows kernel it takes in the dtype
    (`ROWS_KERNELS`) and its CTAs an SM, rows a tile, shared bytes,
    registers a thread and warpgroups a CTA (0 for lbf_layer.cuh's
    kernel)."""
    lib = cuda_lib.load("lbf_stack", _SIGNATURE)
    sa, rows = (ctypes.c_int * 6)(), (ctypes.c_int * 6)()
    cuda_lib.check(lib.lbf_stack_plan(cuda_lib.kernel_dtype(dtype), nv, sa,
                                      rows), "lbf_stack_plan")
    return {"selfattn_kernel": SELFATTN_KERNELS[sa[0]],
            "selfattn_ctas_per_sm": sa[1], "chunk_keys": sa[2],
            "selfattn_smem_bytes": sa[3], "selfattn_registers": sa[4],
            "selfattn_warpgroups": sa[5],
            "rows_kernel": ROWS_KERNELS[rows[5]],
            "rows_ctas_per_sm": rows[0], "rows_tile": rows[1],
            "rows_smem_bytes": rows[2], "rows_registers": rows[3],
            "rows_warpgroups": rows[4]}


def lbf_stack(verts: torch.Tensor, joints: torch.Tensor,
              weights: cuda_lib.Packed, num_heads: int) -> torch.Tensor:
    """The LBF stack: the CUDA kernels for a CUDA tensor, the plain version
    for a CPU tensor (and nothing else: no fallback between the two)."""
    if verts.device.type == "cuda":
        if num_heads != HEADS:
            raise ValueError(f"lbf_stack kernels take {HEADS} heads")
        return lbf_stack_cuda(verts, joints, weights)
    if verts.device.type == "cpu":
        return lbf_stack_ref(verts, joints, weights, num_heads)
    raise ValueError(f"lbf_stack: unsupported device {verts.device}")


# launches of the CUDA kernels (two per layer); the CPU path never counts
lbf_stack.launches = 0
