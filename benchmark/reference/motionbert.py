"""MotionBERT's mesh model in plain float32 PyTorch, over a state dict: the
benchmark's reference for what the port computes on the clip cell.

It follows the published code (github.com/Walter0807/MotionBERT,
lib/model/DSTformer.py `DSTformer`, `Block`, `Attention`; lib/model/
model_mesh.py `MeshRegressor`, `SMPLRegressor`; lib/utils/utils_smpl.py
`rot6d_to_rotmat`; smplx's `lbs` for the SMPL layer it calls with
pose2rot=False) written out as functions of the weights, keyed by
MotionBERT's state-dict names, in its own layout: tokens [N*T, J, C], the
temporal attention through MotionBERT's reshape(-1, T, H, J, D).permute(
0, 2, 3, 1, 4). It imports nothing of the program; the body model is the
asset bundle's raw arrays (reference/smpl.py's `Smpl`), posed here joint
by joint with 4x4 transforms as smplx's `batch_rigid_transform` does.

Departures from the published forward: the output stays in metres (the
head multiplies by 1000), and 'theta' (the axis-angle pose) is not
computed. Eval mode: dropout off, BatchNorm on its running statistics.

`forward(w, tables, cfg, clips, prec=F32)` -> (verts [N, T, V, 3],
kp3d [N, T, 17, 3]); `prec` sets the precision of the backbone's and the
head's matrix products' operands (the control puts fp8 there); SMPL stays
float32, as the program pins it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .model import F32, ein, gelu, layer_norm, lin, no_tf32, softmax
from .smpl import Smpl


def attention(prec, w, p, x, h, mode, seqlen):
    """DSTformer.py `Attention.forward` in mode "spatial" or "temporal" on
    x [N*T, J, C]."""
    bf, n, c = x.shape
    d = c // h
    qkv = lin(prec, x, w, p + "qkv").reshape(bf, n, 3, h, d)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                        # [NT, H, J, D]
    scale = d ** -0.5
    if mode == "spatial":
        a = softmax(ein(prec, "bhnd,bhmd->bhnm", q, k) * scale)
        o = ein(prec, "bhnm,bhmd->bhnd", a, v)
        o = o.transpose(1, 2).reshape(bf, n, c)
    else:
        qt, kt, vt = (z.reshape(-1, seqlen, h, n, d).permute(0, 2, 3, 1, 4)
                      for z in (q, k, v))                   # [N, H, J, T, D]
        a = softmax(ein(prec, "bhjtd,bhjsd->bhjts", qt, kt) * scale)
        o = ein(prec, "bhjts,bhjsd->bhjtd", a, vt)
        o = o.permute(0, 3, 2, 1, 4).reshape(bf, n, c)
    return lin(prec, o, w, p + "proj")


def block(prec, w, cfg, p, x, st_mode, seqlen):
    """`Block.forward`, stage_st or stage_ts."""
    eps, h = cfg["layer_norm_eps"], cfg["num_heads"]

    def half(x, m):
        mode = "spatial" if m == "s" else "temporal"
        x = x + attention(prec, w, p + f"attn_{m}.",
                          layer_norm(x, w[p + f"norm1_{m}.weight"],
                                     w[p + f"norm1_{m}.bias"], eps),
                          h, mode, seqlen)
        y = layer_norm(x, w[p + f"norm2_{m}.weight"],
                       w[p + f"norm2_{m}.bias"], eps)
        return x + lin(prec, gelu(lin(prec, y, w, p + f"mlp_{m}.fc1")), w,
                       p + f"mlp_{m}.fc2")

    for m in (("s", "t") if st_mode == "stage_st" else ("t", "s")):
        x = half(x, m)
    return x


def backbone(prec, w, cfg, clips):
    """DSTformer's `get_representation`: clips [N, T, J, 3] -> rep
    [N, T, J, dim_rep]."""
    p = "backbone."
    b, f, j, c_in = clips.shape
    x = lin(prec, clips.reshape(-1, j, c_in), w, p + "joints_embed")
    x = x + w[p + "pos_embed"]
    bf, _, c = x.shape
    x = x.reshape(-1, f, j, c) + w[p + "temp_embed"][:, :f]
    x = x.reshape(bf, j, c)
    for i in range(cfg["depth"]):
        x_st = block(prec, w, cfg, p + f"blocks_st.{i}.", x, "stage_st", f)
        x_ts = block(prec, w, cfg, p + f"blocks_ts.{i}.", x, "stage_ts", f)
        alpha = softmax(lin(prec, torch.cat([x_st, x_ts], -1), w,
                            p + f"ts_attn.{i}"))
        x = x_st * alpha[:, :, 0:1] + x_ts * alpha[:, :, 1:2]
    x = layer_norm(x, w[p + "norm.weight"], w[p + "norm.bias"],
                   cfg["layer_norm_eps"])
    x = x.reshape(b, f, j, -1)
    return torch.tanh(lin(prec, x, w, p + "pre_logits.fc"))


def batch_norm(x, w, p):
    return ((x - w[p + "running_mean"]) / torch.sqrt(w[p + "running_var"]
                                                     + 1e-5)
            * w[p + "weight"] + w[p + "bias"])


def rot6d_to_rotmat(x):
    """utils_smpl.py: x.view(-1, 3, 2), columns a1 and a2, Gram-Schmidt
    with F.normalize."""
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = torch.nn.functional.normalize(a1, dim=1)
    b2 = torch.nn.functional.normalize(
        a2 - torch.einsum("bi,bi->b", b1, a2).unsqueeze(-1) * b1, dim=1)
    b3 = torch.cross(b1, b2, dim=1)
    return torch.stack((b1, b2, b3), dim=-1)


def smpl_rotmat(smpl: Smpl, rot, betas):
    """smplx `lbs` with pose2rot=False: rot [B, 24, 3, 3], betas [B, 10]
    -> verts [B, V, 3] (metres, no translation)."""
    b = rot.shape[0]
    v_shaped = smpl.v_template + torch.einsum("vcs,bs->bvc", smpl.shapedirs,
                                              betas)
    j_rest = torch.einsum("jv,bvc->bjc", smpl.j_regressor, v_shaped)
    eye = torch.eye(3, device=rot.device)
    feat = (rot[:, 1:] - eye).reshape(b, -1)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", smpl.posedirs, feat)
    rel = j_rest.clone()
    rel[:, 1:] = j_rest[:, 1:] - j_rest[:, smpl.parents[1:]]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=rot.device)
    mats = torch.cat([torch.cat([rot, rel[..., None]], -1),
                      bottom.expand(b, 24, 1, 4)], -2)      # [B, 24, 4, 4]
    chain = [mats[:, 0]]
    for i in range(1, 24):
        chain.append(chain[smpl.parents[i]] @ mats[:, i])
    g = torch.stack(chain, 1)
    j_homo = torch.cat([j_rest, torch.zeros_like(j_rest[..., :1])], -1)
    a = g.clone()
    a[..., 3] = g[..., 3] - (g @ j_homo[..., None])[..., 0]
    t = torch.einsum("vj,bjk->bvk", smpl.weights, a.reshape(b, 24, 16))
    t = t.reshape(b, -1, 4, 4)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1)
    return (t @ v_homo[..., None])[..., :3, 0]


def head(prec, w, rep):
    """SMPLRegressor's pose and shape (eval) -> (pose6d [N*T, 144], betas
    [N, 10])."""
    p = "head."
    n, t, j, c = rep.shape
    feat = rep.reshape(n, t, -1)
    fp = torch.relu(batch_norm(lin(prec, feat.reshape(n * t, -1), w,
                                   p + "fc1"), w, p + "bn1."))
    fs = feat.permute(0, 2, 1).mean(-1)                     # the T pool
    fs = torch.relu(batch_norm(lin(prec, fs, w, p + "fc2"), w, p + "bn2."))
    pose6d = lin(prec, fp, w, p + "head_pose") + w[p + "init_pose"]
    betas = lin(prec, fs, w, p + "head_shape") + w[p + "init_shape"]
    return pose6d, betas


def pose_mesh(tables, pose6d, betas_frames):
    """SMPL from the 6D pose -> (verts [B, V, 3], kp3d [B, 17, 3])."""
    rot = rot6d_to_rotmat(pose6d).reshape(-1, 24, 3, 3)
    verts = smpl_rotmat(tables["smpl"], rot, betas_frames)
    return verts, torch.einsum("jv,bvc->bjc", tables["j_h36m"], verts)


def forward(w: Dict[str, torch.Tensor], tables: Dict, cfg: dict,
            clips: torch.Tensor, prec=F32):
    """MeshRegressor.forward -> (verts [N, T, V, 3], kp3d [N, T, 17, 3])
    in metres."""
    no_tf32()
    n, t = clips.shape[:2]
    pose6d, betas = head(prec, w, backbone(prec, w, cfg, clips))
    betas = betas.expand(t, n, -1).permute(1, 0, 2).reshape(n * t, -1)
    verts, kp3d = pose_mesh(tables, pose6d, betas)
    return (verts.reshape(n, t, -1, 3), kp3d.reshape(n, t, -1, 3))


def init_mesh(w: Dict[str, torch.Tensor], tables: Dict):
    """(verts [V, 3], kp3d [17, 3]) at init_pose and init_shape: what the
    head gives before any input moves it."""
    no_tf32()
    verts, kp3d = pose_mesh(tables, w["head.init_pose"], w["head.init_shape"])
    return verts[0], kp3d[0]


def tables_of(assets, device) -> Dict:
    """What the reference reads of the asset bundle: the neutral body
    model's arrays and the H36M joint regressor."""
    return {"smpl": Smpl(assets.smpl, device),
            "j_h36m": torch.as_tensor(np.asarray(assets.j_regressor_h36m),
                                      dtype=torch.float32, device=device)}
