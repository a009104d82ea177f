"""A plain twin of the self-attention kernel of K2-layer and T1
(`attn_kernel`, csrc/lbf_layer.cuh) on the CPU: its arithmetic in PyTorch,
64-key tile by 64-key tile, held to the port's plain versions
`lbf_layer_ref` (K2-layer) and `run_layers_ref` (T1).

The kernel cannot run here, so this twin says what it computes:
  * the softmax modes (K2-layer; T1's full, preproj, fold1dot) in two
    passes over 64-key tiles: base-2 logits s * (scale * log2(e)) in f32;
    pass 1 each row's max and sum online; pass 2 the scores again,
    p = T(exp2(logit - max) * (1 / sum)) and o += p @ V in f32;
  * bf16smax in three sweeps: st = T(s * scale); the max of st; the sum
    of e = T(exp2(T(st - max) * log2(e))), rounded to T; p = T(e / sum);
  * nosoftmax in one: p = T(s * scale / 431);
  * the epilogue: T(o) @ L3 with the residual under the rounding policy
    (K2-layer y3 + T(T(o @ L3) + b); T1 (y3 + o @ L3) + b), or for
    preproj and fold1dot, whose V rows are already through L3,
    (y3 + (o_0 + o_1)) + b.
The row-local part is the plain versions' own arithmetic, so only the
attention differs between the twin and the plain version.

Bars: f32 max abs 1e-5; bf16 at least 95 % (K2-layer) or 90 % (T1's
attention modes) of the output elements bit-equal, the bars at which
tests/test_torch_lbf_layer.py and tests/test_torch_mdr_ablate.py hold the
plain versions to the JAX package. One layer, B=3, Nv 431 and a ragged 50.
This file imports no JAX.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gator_tpu_torch.nn import (layer_norm32, lbf_layer_ref, run_layers_ref,
                                std_layer_norm)
from gator_tpu_torch.nn.lbf_ablate import ATTN_KERNELS
from gator_tpu_torch.nn.lbf_layer import STACK_FIELDS, pack_layer

H, D, C, KT = 2, 32, 64, 64
F32 = np.float32
# the kernel's constants, each rounded once to f32 as the C++ rounds them
SCALE = torch.tensor(F32(0.17677669529663687))
SCALE_NOSOFTMAX = torch.tensor(F32(0.17677669529663687 / 431.0))
LOG2E = torch.tensor(F32(1.4426950408889634))
SCALE_LOG2E = torch.tensor(F32(0.17677669529663687) * F32(1.4426950408889634))
VARIANTS = ("lbf_layer",) + ATTN_KERNELS
BIT_EQUAL = {"lbf_layer": 0.95, **{m: 0.9 for m in ATTN_KERNELS}}


def random_layer(rng, dtype):
    """One layer's weights in STACK_FIELDS order, init-like scales."""
    shapes = {"fc1_w": (C, 256), "fc1_b": (256,), "fc2_w": (256, C)}
    params = {}
    for name in STACK_FIELDS:
        matrix = name in ("wq", "wk", "wv") or (
            name.endswith("_w") and not name.startswith("ln"))
        shape = shapes.get(name, (C, C) if matrix else (C,))
        if len(shape) == 2:
            v = rng.normal(0.0, shape[0] ** -0.5, size=shape)
        else:
            one = name in ("ln1_w", "ln2_w", "a2")
            v = float(one) + rng.normal(0.0, 0.1, size=shape)
        params[name] = torch.from_numpy(v.astype(F32))
    return pack_layer(params, dtype, "cpu")


def _heads(t):
    b, n, c = t.shape
    return t.reshape(b, n, H, c // H).transpose(1, 2)


def _merge(t):
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def rows(x, jf, p, dt, variant):
    """The row-local launch's outputs as the plain versions compute them:
    y3 (the residual: rounded under K2-layer's policy, f32 under T1's),
    q2, k2 and the self-attention's V rows."""
    def rnd(t):
        return t.to(dt).float()

    scale = D ** -0.5
    if variant == "lbf_layer":   # lbf_layer_ref
        def linear(t, name):
            return rnd(rnd(t @ p[name + "_w"]) + p[name + "_b"])

        def attend(q, k, v):
            prob = rnd(torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1))
            return rnd(_merge(prob @ v))

        yv = rnd(layer_norm32(x, p["ln1_w"], p["ln1_b"]))
        yj = rnd(layer_norm32(jf, p["ln1_w"], p["ln1_b"]))
        o = attend(_heads(rnd(yv @ p["wq"])), _heads(rnd(yj @ p["wk"])),
                   _heads(rnd(yj @ p["wv"])))
        x1 = x + linear(o, "proj")
        y2 = rnd(layer_norm32(x1, p["ln2_w"], p["ln2_b"]))
        x2 = x1 + linear(rnd(F.gelu(linear(y2, "fc1"))), "fc2")
        y3 = rnd(std_layer_norm(x2, p["a2"], p["b2"]))
        return (y3, *(linear(y3, f"l{i}") for i in range(3)))

    def linear(t, name):         # run_layers_ref's `_layer_ref`, mode full
        return t @ p[name + "_w"] + p[name + "_b"]

    yv = rnd(layer_norm32(x, p["ln1_w"], p["ln1_b"]))
    yj = rnd(layer_norm32(jf, p["ln1_w"], p["ln1_b"]))
    q, k, v = (_heads(rnd(y @ p[w])) for y, w in
               ((yv, "wq"), (yj, "wk"), (yj, "wv")))
    prob = rnd(torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1))
    x1 = x + (_merge(rnd(prob @ v)) @ p["proj_w"] + p["proj_b"])
    pre = linear(rnd(layer_norm32(x1, p["ln2_w"], p["ln2_b"])), "fc1")
    x2 = x1 + linear(rnd(F.gelu(pre)), "fc2")
    y3 = std_layer_norm(x2, p["a2"], p["b2"])
    y3d = rnd(y3)
    q2, k2, v2 = (rnd(linear(y3d, f"l{i}")) for i in range(3))
    if variant == "preproj":
        v2 = rnd((v2 @ p["l3_w"]) * (1.0 / H))
    elif variant == "fold1dot":
        v2 = _merge(rnd(_heads(v2) @ p["l3_w"].reshape(H, D, C)))
    return y3, q2, k2, v2


def attention_twin(y3, q2, k2, v, p, dt, variant):
    """The self-attention launch: T [B, Nv, C] out of the row launch's
    outputs, tile by tile as the kernel computes it."""
    def rnd(t):
        return t.to(dt).float()

    b, nv, _ = q2.shape
    wide = variant in ("preproj", "fold1dot")
    qh, kh = _heads(q2), _heads(k2)
    if variant == "preproj":     # one row, both heads
        vh = v[:, None].expand(b, H, nv, C)
    elif variant == "fold1dot":  # each head its own C-wide row
        vh = v.reshape(b, nv, H, C).transpose(1, 2)
    else:
        vh = _heads(v)
    tiles = [slice(k0, min(k0 + KT, nv)) for k0 in range(0, nv, KT)]

    def scores(t):
        return qh @ kh[:, :, t].transpose(-1, -2)

    o = torch.zeros(b, H, nv, vh.shape[-1])
    if variant == "nosoftmax":
        for t in tiles:
            o = o + rnd(scores(t) * SCALE_NOSOFTMAX) @ vh[:, :, t]
    elif variant == "bf16smax":
        def st(t):
            return rnd(scores(t) * SCALE)

        mx = torch.stack([st(t).amax(-1) for t in tiles]).amax(0)[..., None]

        def e(t):
            return rnd(torch.exp2(rnd(st(t) - mx) * LOG2E))

        total = torch.zeros(b, H, nv, 1)
        for t in tiles:
            total = total + e(t).sum(-1, keepdim=True)
        total = rnd(total)
        for t in tiles:
            o = o + rnd(e(t) / total) @ vh[:, :, t]
    else:
        mx = torch.full((b, H, nv, 1), -torch.inf)
        total = torch.zeros(b, H, nv, 1)
        for t in tiles:          # pass 1: max and sum, online
            s = scores(t) * SCALE_LOG2E
            mn = torch.maximum(mx, s.amax(-1, keepdim=True))
            total = total * torch.exp2(mx - mn) + torch.exp2(s - mn).sum(
                -1, keepdim=True)
            mx = mn
        inv = 1.0 / total
        for t in tiles:          # pass 2: the scores again, PV
            p_t = rnd(torch.exp2(scores(t) * SCALE_LOG2E - mx) * inv)
            o = o + p_t @ vh[:, :, t]
    if wide:
        return ((y3 + (o[:, 0] + o[:, 1])) + p["l3_b"]).to(dt)
    v3 = rnd(_merge(o)) @ p["l3_w"]
    if variant == "lbf_layer":
        return (y3 + rnd(rnd(v3) + p["l3_b"])).to(dt)
    return ((y3 + v3) + p["l3_b"]).to(dt)


def _case(variant, nv, dtype):
    rng = np.random.default_rng(nv + VARIANTS.index(variant))
    w = random_layer(rng, dtype)
    verts = torch.from_numpy(rng.normal(size=(3, nv, C)).astype(F32))
    joints = torch.from_numpy(rng.normal(size=(3, 17, C)).astype(F32))
    return w, verts.to(dtype), joints.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv", [431, 50])
@pytest.mark.parametrize("variant", VARIANTS)
def test_attention_twin_matches_plain_version(variant, nv, dtype):
    w, verts, joints = _case(variant, nv, dtype)
    p = {k: v.float() for k, v in w.layers[0].items()}
    y3, q2, k2, v = rows(verts.float(), joints.float(), p, dtype, variant)
    got = attention_twin(y3, q2, k2, v, p, dtype, variant)
    if variant == "lbf_layer":
        want = lbf_layer_ref(verts, joints, w, H)
    else:
        want = run_layers_ref(verts, joints, [w], H, 1, variant)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5, diff.max().item()
    else:
        frac = (got == want).float().mean().item()
        print(f"{variant} Nv={nv} bf16: bit-equal {frac:.4f}, max abs "
              f"{diff.max().item():.2e}")
        assert frac >= BIT_EQUAL[variant], frac
