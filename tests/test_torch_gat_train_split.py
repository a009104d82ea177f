"""K5's backward split on the CPU: a plain twin of what the card's launches
write, held to autograd through the plain version.

On the card a block's backward is cut into gat_block_bwd (one CTA per tile
of whole samples: dx, the per-row cotangent operands of the ten weight
gradients, and the tile's sums for the biases, LayerNorms, MGCN graph
tensors and the hop/path bias), gat_block_wgrad (each weight gradient
X^T dY over all rows, in `launch_plan`'s chunks of 64-row chains added in
f32) and the fixed-order reductions of the chunks and the tiles. The twin
below forms the same operands from the forward's saved ones with plain
torch ops, then every gradient from them in that chunk and tile order, and
is held to `gat_block_train_ref`'s autograd gradients at full width
(C=128, 8 heads, hidden 512), depth 2, default dropout rates, f32: each
gradient within 1e-5 of autograd's, scaled by its max (the qkv key-bias
slice has a zero true gradient and is held to an absolute 1e-5).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gator_tpu_torch.nn import gat_trunk_train as k5
from gator_tpu_torch.nn.gat_trunk_train import (BLOCK_PARAM_KEYS, BlockCfg,
                                                block_masks,
                                                gat_block_train_ref,
                                                launch_plan)

C, H, HID, C2 = 128, 8, 512, 16
D = C // H
RATES = dict(attn_rate=0.4, proj_rate=0.4, mlp_rate=0.1, path_rate=0.2)


def _params(seed, j):
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.08):
        return torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))

    p = {
        "norm1_scale": 1.0 + w(C), "norm1_bias": w(C),
        "qkv_w": w(C, 3 * C), "qkv_b": w(3 * C), "proj_w": w(C, C),
        "proj_b": w(C), "gcn_w0": w(C, C), "gcn_w1": w(C, C),
        "gcn_m": 1.0 + w(j, C), "gcn_adj_diag": 1.0 + w(j, 1),
        "gcn_adj_off": w(j, j, s=0.3) * (1 - torch.eye(j)), "gcn_b": w(C),
        "x0_w": w(C, C), "x0_b": w(C), "x1_w": w(C, C2), "x1_b": w(C2),
        "back_w0": w(C, C), "back_w1": w(C2, C), "back_b": w(C),
        "norm2_scale": 1.0 + w(C), "norm2_bias": w(C),
        "fc1_w": w(C, HID), "fc1_b": w(HID), "fc2_w": w(HID, C),
        "fc2_b": w(C),
    }
    return {k: p[k] for k in BLOCK_PARAM_KEYS}


def _ln(x, w, b):
    return F.layer_norm(x, x.shape[-1:], w, b, 1e-5)


def _ln_bwd(dy, x, w):
    """dx of LayerNorm and the rows' normalised input (eps 1e-5)."""
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    xh = (x - mean) * rstd
    g = dy * w
    dx = rstd * (g - g.mean(-1, keepdim=True)
                 - xh * (g * xh).mean(-1, keepdim=True))
    return dx, xh


def _gelu_grad(x):
    cdf = 0.5 * (1 + torch.erf(x / np.sqrt(2.0)))
    return cdf + x * torch.exp(-0.5 * x * x) / np.sqrt(2 * np.pi)


def _one(m):
    return 1.0 if m is None else m


def forward_ops(x, bias, xm, p, mk):
    """The forward as gat_block_fwd computes it, and the per-row operands
    it saves (`ops` columns by name, each [B*J, width]; x1 in f32)."""
    b, j, _ = x.shape
    y = _ln(x, p["norm1_scale"], p["norm1_bias"])
    qkv = y @ p["qkv_w"] + p["qkv_b"]
    q, k, v = qkv.view(b, j, 3, H, D).unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * D ** -0.5 + bias
    prob = torch.softmax(s, -1)
    pd = prob * _one(mk["attn"])
    a1 = torch.einsum("bhnm,bmhd->bnhd", pd, v).reshape(b, j, C)
    attn = (a1 @ p["proj_w"] + p["proj_b"]) * _one(mk["proj"])
    g0, g1 = y @ p["gcn_w0"], y @ p["gcn_w1"]
    m = p["gcn_m"]
    gcn = p["gcn_adj_diag"] * (g0 * m) \
        + torch.einsum("nm,bmc->bnc", p["gcn_adj_off"], g1 * m) + p["gcn_b"]
    z = (attn + gcn) * _one(mk["dp1"])
    f0p = z @ p["x0_w"] + p["x0_b"]
    f1p = z @ p["x1_w"] + p["x1_b"]
    f0 = torch.einsum("nm,bmc->bnc", xm[0], f0p)
    f1 = torch.einsum("nm,bmc->bnc", xm[1], f1p)
    x1 = x + (f0 @ p["back_w0"] + f1 @ p["back_w1"] + p["back_b"])
    y2 = _ln(x1, p["norm2_scale"], p["norm2_bias"])
    pre = y2 @ p["fc1_w"] + p["fc1_b"]
    hhd = F.gelu(pre) * _one(mk["mlp1"])
    mm2 = (hhd @ p["fc2_w"] + p["fc2_b"]) * _one(mk["mlp2"])
    out = x1 + mm2 * _one(mk["dp2"])
    rows = {"y": y, "qkv": qkv, "a1": a1, "g0": g0, "g1": g1, "z": z,
            "f0": f0, "f1": f1, "y2": y2, "pre": pre, "hhd": hhd}
    ops = {n: t.reshape(b * j, -1) for n, t in rows.items()}
    return out, ops, x1


def backward_rows(x, bias, xm, p, mk, ops, x1, gout):
    """gat_block_bwd's work from the saved operands: dx, the cotangent
    operands (per row) and the small gradients' per-row terms."""
    b, j, _ = x.shape
    sv = {n: t.view(b, j, -1) for n, t in ops.items()}
    dmm2 = gout * _one(mk["dp2"]) * _one(mk["mlp2"])
    dpre = (dmm2 @ p["fc2_w"].T) * _one(mk["mlp1"]) * _gelu_grad(sv["pre"])
    dy2 = dpre @ p["fc1_w"].T
    dln2, xh2 = _ln_bwd(dy2, x1, p["norm2_scale"])
    dx1 = gout + dln2
    df0, df1 = dx1 @ p["back_w0"].T, dx1 @ p["back_w1"].T
    df0p = torch.einsum("nm,bnc->bmc", xm[0], df0)
    df1p = torch.einsum("nm,bnc->bmc", xm[1], df1)
    dz = (df0p @ p["x0_w"].T + df1p @ p["x1_w"].T) * _one(mk["dp1"])
    datt = dz * _one(mk["proj"])
    da1 = (datt @ p["proj_w"].T).view(b, j, H, D)
    m = p["gcn_m"]
    dh0 = p["gcn_adj_diag"] * dz
    dh1 = torch.einsum("mn,bmc->bnc", p["gcn_adj_off"], dz)
    q, k, v = sv["qkv"].view(b, j, 3, H, D).unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * D ** -0.5 + bias
    prob = torch.softmax(s, -1)
    dprob = torch.einsum("bnhd,bmhd->bhnm", da1, v) * _one(mk["attn"])
    ds = prob * (dprob - (dprob * prob).sum(-1, keepdim=True))
    pd = prob * _one(mk["attn"])
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k) * D ** -0.5
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q) * D ** -0.5
    dv = torch.einsum("bhnm,bnhd->bmhd", pd, da1)
    dqkv = torch.stack([dq, dk, dv], 2).reshape(b, j, 3 * C)
    dh0m, dh1m = dh0 * m, dh1 * m
    dy = dqkv @ p["qkv_w"].T + dh0m @ p["gcn_w0"].T + dh1m @ p["gcn_w1"].T
    dln1, xh1 = _ln_bwd(dy, x, p["norm1_scale"])
    dx = dx1 + dln1
    cot = {"dmm2": dmm2, "dpre": dpre, "dx1": dx1, "df0p": df0p,
           "df1p": df1p, "dh0m": dh0m, "dh1m": dh1m, "datt": datt,
           "dqkv": dqkv}
    ops = dict(ops, **{n: t.reshape(b * j, -1) for n, t in cot.items()})
    # per-row (or per-sample) terms of the small gradients
    terms = {
        "norm1_scale": dy * xh1, "norm1_bias": dy, "qkv_b": dqkv,
        "proj_b": datt, "gcn_b": dz, "x0_b": df0p, "x1_b": df1p,
        "back_b": dx1, "norm2_scale": dy2 * xh2, "norm2_bias": dy2,
        "fc1_b": dpre, "fc2_b": dmm2,
        # per sample, summed over samples only
        "gcn_m": dh0 * sv["g0"] + dh1 * sv["g1"],
        "gcn_adj_diag": (sv["g0"] * m * dz).sum(-1, keepdim=True),
        "gcn_adj_off": torch.einsum("bnc,bmc->bnm", dz, sv["g1"] * m),
        "hop": ds,
    }
    return dx, ops, terms


# gat_block_wgrad's products: (forward operand, cotangent) per weight
WGRAD = {"qkv_w": ("y", "dqkv"), "proj_w": ("a1", "datt"),
         "gcn_w0": ("y", "dh0m"), "gcn_w1": ("y", "dh1m"),
         "x0_w": ("z", "df0p"), "x1_w": ("z", "df1p"),
         "back_w0": ("f0", "dx1"), "back_w1": ("f1", "dx1"),
         "fc1_w": ("y2", "dpre"), "fc2_w": ("hhd", "dmm2")}


def grads_from_ops(ops, terms, plan, b, j):
    """Each gradient in the kernels' order: weights as chunks of `wper`
    rows, each a sum of 64-row chains added in f32, the chunks added in
    order; the small ones as tile sums (rows in order), tiles in order."""
    grads = {}
    for name, (fa, fb) in WGRAD.items():
        a, g = ops[fa], ops[fb]
        total = None
        for c0 in range(0, plan["rows"], plan["wper"]):
            part = torch.zeros(a.shape[1], g.shape[1])
            for r0 in range(c0, min(c0 + plan["wper"], plan["rows"]),
                            k5.WGRAD_ROWS):
                r1 = min(r0 + k5.WGRAD_ROWS, plan["rows"])
                part = part + a[r0:r1].T @ g[r0:r1]
            total = part if total is None else total + part
        grads[name] = total
    per_sample = ("gcn_m", "gcn_adj_diag", "gcn_adj_off", "hop")
    for name, t in terms.items():
        total = None
        for t0 in range(0, b, plan["g"]):
            tile = t[t0:t0 + plan["g"]]
            s = tile.sum(0) if name in per_sample \
                else tile.reshape(-1, tile.shape[-1]).sum(0)
            total = s if total is None else total + s
        grads[name] = total
    return grads


def _scaled(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-6)).item()


@pytest.mark.parametrize("b,j", [(3, 17), (4, 19), (13, 5)])
def test_split_backward_matches_autograd_at_full_width(b, j):
    """Depth 2 (the second block's dx is the first's output cotangent), at
    17 and 19 joints (one sample a tile) and 5 (six a tile, three tiles
    with a ragged last)."""
    torch.manual_seed(0)
    rng = np.random.default_rng(j)
    x0 = torch.from_numpy(rng.normal(size=(b, j, C)).astype(np.float32))
    bias = torch.from_numpy(
        rng.normal(0, 0.3, (H, j, j)).astype(np.float32))
    xm = torch.from_numpy((rng.uniform(size=(2, j, j)) < 0.4)
                          .astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(b, j, C)).astype(np.float32))
    params = [_params(10 + i, j) for i in range(2)]
    masks = [block_masks(BlockCfg(num_heads=H, block=i, seed=7, **RATES), b,
                         j, C) for i in range(2)]
    assert all(m is not None for m in masks[0].values())

    # autograd through the plain version
    xr = x0.clone().requires_grad_(True)
    br = bias.clone().requires_grad_(True)
    pr = [{k: t.clone().requires_grad_(True) for k, t in p.items()}
          for p in params]
    y = xr
    for p, mk in zip(pr, masks):
        y = gat_block_train_ref(y, br, p, xm, mk, H)
    y.backward(cot)

    # the twin: forwards saving ops, then backwards block by block
    plan = launch_plan(b, j)
    saved, x = [], x0
    for p, mk in zip(params, masks):
        out, ops, x1 = forward_ops(x, bias, xm, p, mk)
        saved.append((x, ops, x1))
        x = out
    np.testing.assert_allclose(x.numpy(), y.detach().numpy(), atol=1e-5)
    g, dbias = cot, torch.zeros_like(bias)
    for i in (1, 0):
        xi, ops, x1 = saved[i]
        g, ops, terms = backward_rows(xi, bias, xm, params[i], masks[i],
                                      ops, x1, g)
        got = grads_from_ops(ops, terms, plan, b, j)
        dbias = dbias + got.pop("hop")
        for name in BLOCK_PARAM_KEYS:
            want = pr[i][name].grad
            have = got[name].view(want.shape)
            if name == "qkv_b":
                assert have[C:2 * C].abs().max() < 1e-5
                keep = torch.ones(3 * C, dtype=torch.bool)
                keep[C:2 * C] = False
                have, want = have[keep], want[keep]
            assert _scaled(have, want) <= 1e-5, (i, name)
    assert _scaled(g, xr.grad) <= 1e-5
    assert _scaled(dbias, br.grad) <= 1e-5
