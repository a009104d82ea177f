"""HMR 2.0 in plain float32 PyTorch, over a state dict: the benchmark's
reference for what the port computes on the crop cell.

It follows the published code (github.com/shubham-goel/4D-Humans:
hmr2/models/hmr2.py `HMR2.forward_step`; hmr2/models/backbones/vit.py
`ViT.forward_features`, `PatchEmbed`, `Block`, `Attention`, `Mlp`;
hmr2/models/heads/smpl_head.py `SMPLTransformerDecoderHead.forward`;
hmr2/models/components/pose_transformer.py `TransformerDecoder`,
`TransformerCrossAttn`, `PreNorm`, `Attention`, `CrossAttention`,
`FeedForward`; hmr2/utils/geometry.py `rot6d_to_rotmat`; smplx's `lbs`
with pose2rot=False) written out as functions of the weights, keyed by
HMR 2.0's state-dict names, in its own layouts: the backbone's qkv
reshaped (B, N, 3, H, -1).permute(2, 0, 3, 1, 4) with q scaled before
q kᵀ, its tokens turned into a [B, C, Hp, Wp] map and back; the decoder's
qkv and kv chunked and rearranged "b n (h d) -> b h n d". It imports
nothing of the program; the body model is the asset bundle's raw arrays
(reference/smpl.py's `Smpl`), posed joint by joint with 4x4 transforms as
smplx's `batch_rigid_transform` does.

Departures from the published forward: the 44 joints of HMR 2.0's SMPL
wrapper (J_regressor_extra.npy and the OpenPose map, downloads) are not
computed, `joints` being the 24 SMPL joints; the 2D keypoint projection
and the axis-angle outputs are left out. Eval mode: dropout and DropPath
off.

`forward(w, tables, cfg, crops, prec=F32)` -> (verts [B, V, 3], joints
[B, 24, 3], cam_t [B, 3]); `prec` sets the precision of the backbone's,
the decoder's and the head's products' operands (`prec.q`, the patch
embed's too) and, where it has a `keep`, of every tensor the program holds
in its served type between operations (`held`): each product's output,
the attention's, the norms' and GELU's, the residual stream after each
add. The control, `FP8Held`, puts fp8 in both places, as the program puts
bf16; SMPL and the head's sums with the mean parameters stay float32, as
the program pins them.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import lowp
from .model import F32, ein, gelu, layer_norm, lin, no_tf32, softmax
from .smpl import Smpl


class FP8Held(lowp.FP8):
    """The control's precision: fp8 (e4m3, a scale a tensor) wherever the
    program computes in bfloat16: the products' operands (lowp.FP8) and
    every tensor it holds between operations (`held`)."""
    keep = staticmethod(lowp.FP8.q)


def held(prec, x):
    """x as the program holds it between operations: rounded by the
    precision's `keep` where it has one, else as computed."""
    keep = getattr(prec, "keep", None)
    return x if keep is None else keep(x)


def patch_embed(prec, w, cfg, x):
    """PatchEmbed: the padded conv, flatten(2).transpose(1, 2)."""
    y = F.conv2d(prec.q(x), prec.q(w["backbone.patch_embed.proj.weight"]),
                 w["backbone.patch_embed.proj.bias"],
                 stride=cfg["patch_size"], padding=cfg["patch_padding"])
    hp, wp = y.shape[2:]
    return held(prec, y.flatten(2).transpose(1, 2)), (hp, wp)


def vit_block(prec, w, cfg, p, x):
    """vit.py `Block`: x + attn(norm1 x), then x + mlp(norm2 x)."""
    b, n, c = x.shape
    h = cfg["num_heads"]
    eps = cfg["layer_norm_eps"]
    y = held(prec, layer_norm(x, w[p + "norm1.weight"], w[p + "norm1.bias"],
                              eps))
    qkv = held(prec, lin(prec, y, w, p + "attn.qkv")).reshape(b, n, 3, h, -1)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                       # [B, H, N, D]
    q = q * (c // h) ** -0.5
    a = softmax(ein(prec, "bhnd,bhmd->bhnm", q, k))
    o = held(prec, ein(prec, "bhnm,bhmd->bhnd", a, v))
    o = o.transpose(1, 2).reshape(b, n, -1)
    x = held(prec, x + held(prec, lin(prec, o, w, p + "attn.proj")))
    y = held(prec, layer_norm(x, w[p + "norm2.weight"], w[p + "norm2.bias"],
                              eps))
    y = held(prec, gelu(held(prec, lin(prec, y, w, p + "mlp.fc1"))))
    return held(prec, x + held(prec, lin(prec, y, w, p + "mlp.fc2")))


def backbone(prec, w, cfg, img):
    """`ViT.forward_features` on the sliced crop -> [B, C, Hp, Wp]."""
    b = img.shape[0]
    x, (hp, wp) = patch_embed(prec, w, cfg, img)
    pe = w["backbone.pos_embed"]
    x = held(prec, x + held(prec, pe[:, 1:] + pe[:, :1]))
    for i in range(cfg["depth"]):
        x = vit_block(prec, w, cfg, f"backbone.blocks.{i}.", x)
    x = held(prec, layer_norm(x, w["backbone.last_norm.weight"],
                              w["backbone.last_norm.bias"],
                              cfg["layer_norm_eps"]))
    return x.permute(0, 2, 1).reshape(b, -1, hp, wp)


def heads_of(t, h):
    """rearrange "b n (h d) -> b h n d"."""
    b, n, _ = t.shape
    return t.reshape(b, n, h, -1).transpose(1, 2)


def attend(prec, q, k, v, scale):
    a = softmax(ein(prec, "bhnd,bhmd->bhnm", q, k) * scale)
    o = held(prec, ein(prec, "bhnm,bhmd->bhnd", a, v))
    b, h, n, d = o.shape
    return o.transpose(1, 2).reshape(b, n, h * d)          # "b n (h d)"


def decoder(prec, w, cfg, token, ctx):
    """`TransformerDecoder.forward(token, context=ctx)`."""
    p = "smpl_head.transformer."
    h, eps = cfg["dec_heads"], cfg["dec_layer_norm_eps"]
    scale = cfg["dec_dim_head"] ** -0.5
    x = lin(prec, token, w, p + "to_token_embedding")
    x = held(prec, x + w[p + "pos_embedding"][:, :x.shape[1]])

    def norm(x, q):
        return held(prec, layer_norm(x, w[q + "norm.weight"],
                                     w[q + "norm.bias"], eps))

    def out(y, name, bias=True):
        return held(prec, lin(prec, y, w, name, bias))

    for i in range(cfg["dec_depth"]):
        q0 = p + f"transformer.layers.{i}."
        y = norm(x, q0 + "0.")
        qkv = out(y, q0 + "0.fn.to_qkv", bias=False).chunk(3, -1)
        o = attend(prec, *(heads_of(t, h) for t in qkv), scale)
        x = held(prec, out(o, q0 + "0.fn.to_out.0") + x)
        y = norm(x, q0 + "1.")
        k, v = out(ctx, q0 + "1.fn.to_kv", bias=False).chunk(2, -1)
        q = out(y, q0 + "1.fn.to_q", bias=False)
        o = attend(prec, heads_of(q, h), heads_of(k, h), heads_of(v, h),
                   scale)
        x = held(prec, out(o, q0 + "1.fn.to_out.0") + x)
        y = norm(x, q0 + "2.")
        y = held(prec, gelu(out(y, q0 + "2.fn.net.0")))
        x = held(prec, out(y, q0 + "2.fn.net.3") + x)
    return x


def rot6d_to_rotmat(x):
    """hmr2/utils/geometry.py: x.reshape(-1, 2, 3).permute(0, 2, 1), the
    columns a1 = x[:3] and a2 = x[3:], Gram-Schmidt with F.normalize."""
    x = x.reshape(-1, 2, 3).permute(0, 2, 1)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = F.normalize(a1)
    b2 = F.normalize(a2 - torch.einsum("bi,bi->b", b1, a2).unsqueeze(-1)
                     * b1)
    b3 = torch.cross(b1, b2, dim=1)
    return torch.stack((b1, b2, b3), dim=-1)


def smpl_head(prec, w, cfg, feats):
    """`SMPLTransformerDecoderHead.forward` on the backbone's map ->
    (rotations [B, 24, 3, 3], betas [B, 10], cam [B, 3])."""
    b = feats.shape[0]
    ctx = feats.flatten(2).transpose(1, 2)          # "b c h w -> b (h w) c"
    p = "smpl_head."
    pose = w[p + "init_body_pose"].expand(b, -1)
    betas = w[p + "init_betas"].expand(b, -1)
    cam = w[p + "init_cam"].expand(b, -1)
    for _ in range(cfg["ief_iters"]):
        token = torch.zeros(b, 1, 1, device=feats.device)
        out = decoder(prec, w, cfg, token, ctx)[:, 0]
        pose = held(prec, lin(prec, out, w, p + "decpose")) + pose
        betas = held(prec, lin(prec, out, w, p + "decshape")) + betas
        cam = held(prec, lin(prec, out, w, p + "deccam")) + cam
    return rot6d_to_rotmat(pose).view(b, -1, 3, 3), betas, cam


def smpl_rotmat(smpl: Smpl, rot, betas):
    """smplx `lbs` with pose2rot=False: rot [B, 24, 3, 3], betas [B, 10]
    -> (verts [B, V, 3], posed joints [B, 24, 3]), metres, no
    translation."""
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
    joints = g[..., :3, 3]
    j_homo = torch.cat([j_rest, torch.zeros_like(j_rest[..., :1])], -1)
    a = g.clone()
    a[..., 3] = g[..., 3] - (g @ j_homo[..., None])[..., 0]
    t = torch.einsum("vj,bjk->bvk", smpl.weights, a.reshape(b, 24, 16))
    t = t.reshape(b, -1, 4, 4)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1)
    return (t @ v_homo[..., None])[..., :3, 0], joints


def camera_t(cfg, cam):
    """`forward_step`'s pred_cam_t: [c1, c2, 2 f / (S c0 + 1e-9)]."""
    f = cfg["focal_length"]
    return torch.stack([cam[:, 1], cam[:, 2],
                        2 * f / (cfg["image_size"] * cam[:, 0] + 1e-9)], -1)


def forward(w: Dict[str, torch.Tensor], tables: Dict, cfg: dict,
            crops: torch.Tensor, prec=F32):
    """`HMR2.forward_step` -> (verts [B, V, 3], joints [B, 24, 3], cam_t
    [B, 3])."""
    no_tf32()
    x0 = (cfg["image_size"] - cfg["img_w"]) // 2
    feats = backbone(prec, w, cfg, crops[:, :, :, x0:x0 + cfg["img_w"]])
    rot, betas, cam = smpl_head(prec, w, cfg, feats)
    verts, joints = smpl_rotmat(tables["smpl"], rot, betas)
    return verts, joints, camera_t(cfg, cam)


def init_output(w: Dict[str, torch.Tensor], tables: Dict, cfg: dict):
    """(verts [V, 3], joints [24, 3], cam_t [3]) at the mean parameters:
    what the head gives before any crop moves it."""
    no_tf32()
    p = "smpl_head."
    rot = rot6d_to_rotmat(w[p + "init_body_pose"]).view(1, -1, 3, 3)
    verts, joints = smpl_rotmat(tables["smpl"], rot, w[p + "init_betas"])
    return verts[0], joints[0], camera_t(cfg, w[p + "init_cam"])[0]


def tables_of(assets, device) -> Dict:
    """What the reference reads of the asset bundle: the neutral body
    model's arrays."""
    return {"smpl": Smpl(assets.smpl, device)}
