"""GATOR in plain float32 PyTorch, over a state dict: the benchmark's
reference for what the port computes.

It follows the published model (kasvii/GATOR, lib/models/GAT.py, MDR.py,
backbones/modules.py, vanilla_transformer_encoder.py) written out as
functions of the weights, keyed by the reference's state-dict names. It
imports nothing of the program; the graph tables, the template meshes and
the joint assignment it reads are worked out again in `graph.py` from the
raw files (the joint sets' edge lists, the body model's template, joint
regressors and down-sampling operators).

`forward(w, tables, cfg, pose2d, prec=F32, masks=None, train=False)`:
  * `prec` sets the precision of every matrix product's operands: the
    reference is `F32` (TF32 off); the control is a lower precision in
    its place (`lowp.py`).
  * `masks(unit, mid, shape)` -> a scaled keep mask [B, *shape] or None:
    training's dropout and DropPath at the sites the training kernels
    apply them (K5 in each GAT block, K4 in each LBF layer).
  * `train=True`: the MDR head's BatchNorm takes the batch's statistics
    (biased variance over batch and coordinate) and returns the updated
    running statistics (momentum 0.1), as the port's training step does.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import graph

# dropout mask ids and units of the training kernels (frozen from the
# port's contract with its kernels; see masks.py)
M_ATTN0, M_PROJ, M_DP1, M_MLP1, M_MLP2, M_DP2 = 0, 8, 9, 10, 11, 12
M_SELF0, M_OUT = 16, 24
GAT_UNIT_BASE = 256
GAT_RATES = {"attn": 0.4, "proj": 0.4, "mlp": 0.1, "path_max": 0.2}
LBF_RATES = {"attn": 0.2, "proj": 0.2, "path": 0.2, "mlp": 0.2,
             "self": 0.1, "out": 0.1}


class F32:
    """Product operands in float32, TF32 off."""

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return x


def ein(prec, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(spec, prec.q(a), prec.q(b))


def lin(prec, x: torch.Tensor, w: Dict[str, torch.Tensor], name: str,
        bias: bool = True) -> torch.Tensor:
    y = ein(prec, "...i,oi->...o", x, w[name + ".weight"])
    return y + w[name + ".bias"] if bias else y


def gelu(x):
    return F.gelu(x)            # the exact erf form


def layer_norm(x, weight, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * weight + bias


def std_layer_norm(x, a, b, eps=1e-6):
    """The Annotated Transformer's norm: unbiased std, eps on the std."""
    mu = x.mean(-1, keepdim=True)
    std = torch.sqrt(((x - mu) ** 2).sum(-1, keepdim=True)
                     / (x.shape[-1] - 1))
    return a * (x - mu) / (std + eps) + b


def softmax(x):
    return torch.softmax(x, dim=-1)


def _drop(t, masks, unit, mid, shape):
    if masks is None:
        return t
    m = masks(unit, mid, shape)
    return t if m is None else t * m


def _pinned(table):
    return torch.cat([torch.zeros_like(table[:1]), table[1:]])


def conv1d_len3(prec, x, weight, bias):
    """Conv1d(k=3, padding=1) over the last axis of x [B, Cin, L]."""
    xp = F.pad(x, (1, 1))
    out = bias[None, :, None]
    for k in range(3):
        out = out + ein(prec, "bcl,oc->bol", xp[..., k:k + x.shape[-1]],
                        weight[:, :, k])
    return out


def hop_path_bias(prec, w, t, cfg) -> torch.Tensor:
    """[H, J, J]: hop-distance embedding + per-hop path features
    (GAT.py:89-110, modules.py:77-107)."""
    p = "pose_lifter.get_hop_path_encoding."
    h, j = cfg["gat"]["num_heads"], cfg["num_joint"]
    table = _pinned(w[p + "spatial_pos_encoder.weight"])
    spatial = table[t["spatial_pos"]].permute(2, 0, 1)
    edge = t["edge_input"]                                 # [J, J, D]
    d = edge.shape[-1]
    flat = edge.permute(2, 0, 1).reshape(d, j * j)
    enc = lin(prec, flat, w, p + "edge_encoder")           # [D, J*J*H]
    enc = enc.reshape(d, h, j, j).permute(1, 2, 3, 0)
    return spatial + (w[p + "W"] * enc).sum(-1) * t["hop_recip"]


def gat_block(prec, w, t, cfg, i, x, bias, masks):
    p = f"pose_lifter.blocks.{i}."
    g = cfg["gat"]
    b, j, c = x.shape
    h = g["num_heads"]
    d = c // h
    unit = GAT_UNIT_BASE + i
    path = np.linspace(0.0, GAT_RATES["path_max"], g["depth"])[i]
    y = layer_norm(x, w[p + "norm1.weight"], w[p + "norm1.bias"])
    qkv = lin(prec, y, w, p + "attn.qkv").reshape(b, j, 3, h, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    s = ein(prec, "bnhd,bmhd->bhnm", q, k) * d ** -0.5 + bias[None]
    pr = softmax(s)
    if masks is not None:
        pr = torch.stack([_drop(pr[:, hh], masks, unit, M_ATTN0 + hh, (j, j))
                          for hh in range(h)], 1)
    a = ein(prec, "bhnm,bmhd->bnhd", pr, v).reshape(b, j, c)
    attn = _drop(lin(prec, a, w, p + "attn.proj"), masks, unit, M_PROJ,
                 (j, c))
    adj = t["adjacency"] + w[p + "gcn.adj2"]
    adj = (adj.T + adj) / 2
    eye = torch.eye(j, device=x.device)
    mt = w[p + "gcn.M"]
    h0 = ein(prec, "bjc,co->bjo", y, w[p + "gcn.W"][0]) * mt
    h1 = ein(prec, "bjc,co->bjo", y, w[p + "gcn.W"][1]) * mt
    gcn = (torch.diagonal(adj)[None, :, None] * h0
           + ein(prec, "ij,bjo->bio", adj * (1 - eye), h1)
           + w[p + "gcn.bias"])
    z = attn + gcn
    if path > 0:
        z = _drop(z, masks, unit, M_DP1, (1, 1))
    feats = [ein(prec, "ij,bjc->bic", t["masks_xfeat"][r],
                 lin(prec, z, w, p + f"x_feat.linears.{r}"))
             for r in range(2)]
    x = x + lin(prec, torch.cat(feats, -1), w, p + "x_feat.linearback")
    y2 = layer_norm(x, w[p + "norm2.weight"], w[p + "norm2.bias"])
    hid = _drop(gelu(lin(prec, y2, w, p + "mlp.fc1")), masks, unit, M_MLP1,
                (j, 4 * c))
    m2 = _drop(lin(prec, hid, w, p + "mlp.fc2"), masks, unit, M_MLP2, (j, c))
    if path > 0:
        m2 = _drop(m2, masks, unit, M_DP2, (1, 1))
    return x + m2


def gat(prec, w, t, cfg, pose2d, masks=None):
    """pose2d [B, J, 2] -> (pose3d [B, J, 3] mm, features [B, J, C])."""
    p = "pose_lifter."
    b, j = pose2d.shape[:2]
    x = lin(prec, pose2d, {"a.weight": w[p + "GLinear.0.W"],
                           "a.bias": w[p + "GLinear.0.b"]}, "a")
    # GroupNorm(4, 64): per sample and group over (channels, joints)
    xg = x.reshape(b, j, 4, -1)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    x = ((xg - mu) / torch.sqrt(var + 1e-5)).reshape(b, j, -1)
    x = gelu(x * w[p + "GLinear.1.weight"] + w[p + "GLinear.1.bias"])
    x = lin(prec, x, {"a.weight": w[p + "GLinear.3.W"],
                      "a.bias": w[p + "GLinear.3.b"]}, "a")
    x = x + _pinned(w[p + "pos_id_embed.weight"])[1:j + 1]
    x = x + _pinned(w[p + "pos_num_embed.weight"])[t["degree"]]
    bias = hop_path_bias(prec, w, t, cfg)
    for i in range(cfg["gat"]["depth"]):
        x = gat_block(prec, w, t, cfg, i, x, bias, masks)
    feat = gelu(layer_norm(x, w[p + "norm.weight"], w[p + "norm.bias"]))
    pose3d = lin(prec, feat.reshape(b, -1), w, p + "lifter")
    return pose3d.reshape(b, j, 3), feat


def _heads(x, h):
    b, n, c = x.shape
    return x.reshape(b, n, h, c // h)


def lbf_layer(prec, w, cfg, li, vf, jf, masks):
    sfx = ("", "_1", "_2")[li]
    e, s = f"pose2mesh.encoder{sfx}.", f"pose2mesh.selfatt{sfx}.linears."
    m = cfg["mdr"]
    h = m["num_heads"]
    b, nv, c = vf.shape
    j = jf.shape[1]
    d = c // h
    n1v = layer_norm(vf, w[e + "norm1.weight"], w[e + "norm1.bias"])
    n1j = layer_norm(jf, w[e + "norm1.weight"], w[e + "norm1.bias"])
    q = _heads(lin(prec, n1v, w, e + "attn.wq", bias=False), h)
    k = _heads(lin(prec, n1j, w, e + "attn.wk", bias=False), h)
    v = _heads(lin(prec, n1j, w, e + "attn.wv", bias=False), h)
    pr = softmax(ein(prec, "bnhd,bmhd->bhnm", q, k) * d ** -0.5)
    if masks is not None:
        pr = torch.stack([_drop(pr[:, hh], masks, li, M_ATTN0 + hh, (nv, j))
                          for hh in range(h)], 1)
    a = ein(prec, "bhnm,bmhd->bnhd", pr, v).reshape(b, nv, c)
    o = _drop(lin(prec, a, w, e + "attn.proj"), masks, li, M_PROJ, (nv, c))
    x1 = vf + _drop(o, masks, li, M_DP1, (1, 1))
    y2 = layer_norm(x1, w[e + "norm2.weight"], w[e + "norm2.bias"])
    h1 = _drop(gelu(lin(prec, y2, w, e + "mlp.fc1")), masks, li, M_MLP1,
               (nv, 4 * c))
    h2 = _drop(lin(prec, h1, w, e + "mlp.fc2"), masks, li, M_MLP2, (nv, c))
    x2 = x1 + _drop(h2, masks, li, M_DP2, (1, 1))
    y3 = std_layer_norm(x2, w[f"pose2mesh.norm{sfx}.a_2"],
                        w[f"pose2mesh.norm{sfx}.b_2"])
    q2, k2, v2 = (_heads(lin(prec, y3, w, s + str(i)), h) for i in range(3))
    pr2 = softmax(ein(prec, "bnhd,bmhd->bhnm", q2, k2) / math.sqrt(d))
    if masks is not None:
        pr2 = torch.stack([_drop(pr2[:, hh], masks, li, M_SELF0 + hh,
                                 (nv, nv)) for hh in range(h)], 1)
    a2 = ein(prec, "bhnm,bmhd->bnhd", pr2, v2).reshape(b, nv, c)
    sa = _drop(lin(prec, a2, w, s + "3"), masks, li, M_OUT, (nv, c))
    return y3 + sa


def mdr(prec, w, t, cfg, pose2d, pose3d, feat, masks=None, train=False):
    """-> (mesh [B, V0, 3] m, new BatchNorm running stats or None)."""
    p = "pose2mesh."
    m = cfg["mdr"]
    b, j = pose2d.shape[:2]
    xc = torch.cat([pose2d, pose3d / 1000.0, feat], dim=2)
    verts = torch.cat([t["init_verts_coarse"][None].expand(b, -1, -1),
                       xc[:, t["vj_relation"], 2:5]], dim=2)
    nv = verts.shape[1]
    jf = lin(prec, xc, w, p + "get_joint_feature") \
        + _pinned(w[p + "pos_j_id_embed.weight"])[1:j + 1]
    vf = lin(prec, verts, w, p + "get_verts_feature") \
        + _pinned(w[p + "pos_v_id_embed.weight"])[1:nv + 1]
    for li in range(m["layers"]):
        vf = lbf_layer(prec, w, cfg, li, vf, jf, masks)
    ac = lin(prec, vf, w, p + "motion_linear")
    nb = m["num_basis"]
    mat_a, mat_c = ac[..., :nb], ac[..., -3:]
    mb = lin(prec, vf, w, p + "bias_linear")
    bn = p + "bias_norm."
    stats = None
    if m["alpha"]:
        mb = layer_norm(mb, w[bn + "weight"], w[bn + "bias"])
    else:
        if train:
            mean = mb.mean(dim=(0, 2))
            var = ((mb - mean[None, :, None]) ** 2).mean(dim=(0, 2))
            stats = (0.9 * w[bn + "running_mean"] + 0.1 * mean.detach(),
                     0.9 * w[bn + "running_var"] + 0.1 * var.detach())
        else:
            mean, var = w[bn + "running_mean"], w[bn + "running_var"]
        mb = ((mb - mean[None, :, None]) / torch.sqrt(var[None, :, None]
                                                      + 1e-5)
              * w[bn + "weight"][None, :, None] + w[bn + "bias"][None, :, None])
    mb = conv1d_len3(prec, gelu(mb), w[p + "bias_conv1d.weight"],
                     w[p + "bias_conv1d.bias"])              # [B, K, 3]
    alpha = (torch.pow(1.1, lin(prec, vf, w, p + "scale_linear"))
             if m["alpha"] else 1.0)
    vert = alpha * ein(prec, "bvk,bkc->bvc", softmax(mat_a), mb) + mat_c
    mesh = conv1d_len3(prec, vert, w[p + "upsample_conv.weight"],
                       w[p + "upsample_conv.bias"])
    return mesh + t["init_verts_full"], stats


def forward(w: Dict[str, torch.Tensor], t: Dict[str, torch.Tensor],
            cfg: dict, pose2d: torch.Tensor, prec=F32,
            masks: Optional[Callable] = None, train: bool = False):
    """-> (mesh [B, V0, 3] m, pose3d [B, J, 3] mm, BatchNorm stats)."""
    pose3d, feat = gat(prec, w, t, cfg, pose2d, masks)
    mesh, stats = mdr(prec, w, t, cfg, pose2d, pose3d, feat, masks, train)
    return mesh, pose3d, stats


TABLE_KEYS = ("adjacency", "degree", "spatial_pos", "edge_input",
              "hop_recip", "masks_xfeat", "init_verts_coarse",
              "init_verts_full", "vj_relation")


def arrays_of(assets, joint_set: str) -> Dict[str, np.ndarray]:
    """The tables the reference reads, worked out again (graph.py) from
    the raw files of an asset bundle, for input joint set `joint_set`."""
    return graph.derive(joint_set, graph.raw_of(assets))


def tables_on(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The model's asset arrays as tensors: integer tables as long, the
    rest as float32."""
    out = {}
    for k in TABLE_KEYS:
        a = np.asarray(arrays[k])
        dt = torch.long if a.dtype.kind in "iu" else torch.float32
        out[k] = torch.as_tensor(a, dtype=dt, device=device)
    return out


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
