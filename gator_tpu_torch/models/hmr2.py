"""HMR 2.0: one person crop -> an SMPL mesh, its joints and a camera.

Goel et al., "Humans in 4D: Reconstructing and Tracking Humans with
Transformers", ICCV 2023 (arXiv 2305.20091); code at
github.com/shubham-goel/4D-Humans: the ViT-H/16 backbone
(hmr2/models/backbones/vit.py `vit()`, ViTPose's), the transformer decoder
head (hmr2/models/heads/smpl_head.py `SMPLTransformerDecoderHead` over
hmr2/models/components/pose_transformer.py `TransformerDecoder`) and the
forward of hmr2/models/hmr2.py, at the model settings of
hmr2/configs_hydra/experiment/hmr_vit_transformer.yaml (`Hmr2Spec`'s
defaults).

Crops [B, 3, S, S] normalised by ImageNet's mean and std (S = 256) ->
(verts [B, 6890, 3], joints [B, 24, 3], cam_t [B, 3]) in f32: the SMPL
mesh and its 24 posed joints in metres, and the camera translation
[c1, c2, 2 f / (S c0 + 1e-9)] at HMR 2.0's focal length f = 5000.

The model, tokens of width C = 1280:
  * the crop sliced to its centre 256 x 192 (x[..., 32:-32]);
  * patch embed: Conv2d(3, C, 16, stride 16, padding 2) -> 16 x 12 = 192
    tokens (the 2-pixel pad shifts the patches off the 16-pixel grid; the
    port runs it as one product over the padded image's patches), plus
    pos_embed[:, 1:] + pos_embed[:, :1] (ViTPose's class-token slot
    folded in);
  * 32 pre-norm blocks, x += proj(MHSA(LN1 x)), x += fc2(GELU(fc1(LN2 x))),
    16 heads of 80, LayerNorm eps 1e-6, exact GELU; then last_norm;
  * the decoder: a zero token [B, 1, 1] through Linear(1, 1024) plus
    pos_embedding, then 6 layers of x += SA(LN x) (8 heads of 64, to_qkv
    without bias), x += CA(LN x, ctx) (to_q from the token, to_kv from the
    backbone's 192 tokens, not normalised again; no biases), x +=
    FF(LN x) (1024 -> 1024 -> 1024, GELU), LayerNorm eps 1e-5;
  * the head, one IEF iteration: pose6d = init_body_pose + decpose(x),
    betas = init_betas + decshape(x), cam = init_cam + deccam(x);
  * 6D -> rotation matrices in HMR 2.0's layout, [a1 | a2]
    (`bodymodel.rot6d_to_rotmat`), then SMPL from the 24 rotations
    (`bodymodel.smpl_forward_rotmat`, smplx's pose2rot=False).

The modules carry HMR 2.0's names (`backbone.blocks.{i}.attn.qkv`,
`smpl_head.transformer.transformer.layers.{i}.{0,1,2}`,
`smpl_head.decpose`, ...), so that a released checkpoint's state dict
loads through `train.checkpoint.load_weights`; its SMPL layer's buffers
(`smpl.*`) and its discriminator are left out there, as the body model is
the asset bundle's. The 44-joint output of HMR 2.0's SMPL wrapper (its
`J_regressor_extra.npy` and OpenPose map) is not computed: `joints` are
the 24 SMPL joints.

`hmr2_forward` is the model's function over the weights `fold_weights`
derives once; the serving call (`serving.make_serving_fn`, bf16) and the
module's own `forward` (f32) run it. Products run in the serving type,
LayerNorm statistics in f32 (PyTorch's LayerNorm accumulates a bf16 input
in f32), the head's sums, the 6D rotations and SMPL in f32. Every
attention runs on K3 (`nn.fused_attention_into`) on CUDA, on its plain
version on the CPU: the backbone's on strided views of its qkv product
(16 heads of 80, the tiled kernel), the decoder's cross-attention on a
view of one product that computes all six layers' to_kv at once (one
query against 192 keys, the tiled kernel), its self-attention over the
one token on the short-row kernel. A call is the spans serve.hmr_patch,
serve.hmr_vit, serve.hmr_decoder and serve.hmr_smpl.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..assets.bundle import GatorAssets
from ..assets.smpl_assets import SmplModel
from ..bodymodel import SmplParams, rot6d_to_rotmat, smpl_forward_rotmat
from ..nn import fused_attention_into
from ..profiling import span

SMPL_JOINTS = 24
SHAPE_DIM = 10
CAM_DIM = 3
# HMR 2.0's 6D rest rotation, [a1 | a2] = [1, 0, 0 | 0, 1, 0]
REST_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
# smpl_mean_params.npz's camera (scale, x, y)
MEAN_CAM = (0.9, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Hmr2Spec:
    """HMR 2.0's model settings (hmr_vit_transformer.yaml; vit.py `vit()`;
    the EXTRA.FOCAL_LENGTH and MODEL.IMAGE_SIZE of the camera). The crop is
    `image_size` square; its centre `img_w` columns are the backbone's
    img_h x img_w input."""
    image_size: int = 256
    img_h: int = 256
    img_w: int = 192
    patch_size: int = 16
    patch_padding: int = 2
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    eps: float = 1e-6
    dec_dim: int = 1024
    dec_depth: int = 6
    dec_heads: int = 8
    dec_dim_head: int = 64
    dec_mlp_dim: int = 1024
    dec_eps: float = 1e-5
    focal_length: float = 5000.0

    @property
    def grid(self) -> Tuple[int, int]:
        """The patch grid (rows, columns) the padded conv makes."""
        p, s = self.patch_padding, self.patch_size
        return ((self.img_h + 2 * p - s) // s + 1,
                (self.img_w + 2 * p - s) // s + 1)

    @property
    def num_patches(self) -> int:
        """ViTPose's PatchEmbed.num_patches, the pos_embed rows less its
        class-token slot (the grid without the pad)."""
        return (self.img_h // self.patch_size) * (self.img_w
                                                  // self.patch_size)


class PatchEmbed(nn.Module):
    def __init__(self, spec: Hmr2Spec):
        super().__init__()
        self.proj = nn.Conv2d(3, spec.embed_dim, spec.patch_size,
                              stride=spec.patch_size,
                              padding=spec.patch_padding)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)     # qkv_bias: True
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, spec: Hmr2Spec):
        super().__init__()
        c = spec.embed_dim
        self.norm1 = nn.LayerNorm(c, eps=spec.eps)
        self.attn = Attention(c)
        self.norm2 = nn.LayerNorm(c, eps=spec.eps)
        self.mlp = Mlp(c, int(c * spec.mlp_ratio))


class ViT(nn.Module):
    def __init__(self, spec: Hmr2Spec):
        super().__init__()
        c = spec.embed_dim
        self.patch_embed = PatchEmbed(spec)
        self.pos_embed = nn.Parameter(torch.zeros(1, spec.num_patches + 1, c))
        self.blocks = nn.ModuleList(Block(spec) for _ in range(spec.depth))
        self.last_norm = nn.LayerNorm(c, eps=spec.eps)


def _out(inner: int, dim: int) -> nn.Sequential:
    """to_out: Linear then Dropout (named to_out.0)."""
    return nn.Sequential(nn.Linear(inner, dim), nn.Dropout(0.0))


class SelfAttention(nn.Module):
    def __init__(self, spec: Hmr2Spec):
        super().__init__()
        inner = spec.dec_heads * spec.dec_dim_head
        self.to_qkv = nn.Linear(spec.dec_dim, 3 * inner, bias=False)
        self.to_out = _out(inner, spec.dec_dim)


class CrossAttention(nn.Module):
    def __init__(self, spec: Hmr2Spec):
        super().__init__()
        inner = spec.dec_heads * spec.dec_dim_head
        self.to_kv = nn.Linear(spec.embed_dim, 2 * inner, bias=False)
        self.to_q = nn.Linear(spec.dec_dim, inner, bias=False)
        self.to_out = _out(inner, spec.dec_dim)


class FeedForward(nn.Module):
    def __init__(self, spec: Hmr2Spec):
        super().__init__()
        d, h = spec.dec_dim, spec.dec_mlp_dim
        self.net = nn.Sequential(nn.Linear(d, h), nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(h, d), nn.Dropout(0.0))


class PreNorm(nn.Module):
    def __init__(self, spec: Hmr2Spec, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(spec.dec_dim, eps=spec.dec_eps)
        self.fn = fn


class TransformerCrossAttn(nn.Module):
    def __init__(self, spec: Hmr2Spec):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([PreNorm(spec, SelfAttention(spec)),
                           PreNorm(spec, CrossAttention(spec)),
                           PreNorm(spec, FeedForward(spec))])
            for _ in range(spec.dec_depth))


class TransformerDecoder(nn.Module):
    def __init__(self, spec: Hmr2Spec):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, spec.dec_dim)  # zero token
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, spec.dec_dim))
        self.transformer = TransformerCrossAttn(spec)


class SMPLTransformerDecoderHead(nn.Module):
    def __init__(self, spec: Hmr2Spec):
        super().__init__()
        npose = 6 * SMPL_JOINTS
        self.transformer = TransformerDecoder(spec)
        self.decpose = nn.Linear(spec.dec_dim, npose)
        self.decshape = nn.Linear(spec.dec_dim, SHAPE_DIM)
        self.deccam = nn.Linear(spec.dec_dim, CAM_DIM)
        # smpl_mean_params.npz's pose (6D), shape and camera
        self.register_buffer("init_body_pose",
                             torch.tensor(REST_6D * SMPL_JOINTS)[None])
        self.register_buffer("init_betas", torch.zeros(1, SHAPE_DIM))
        self.register_buffer("init_cam", torch.tensor(MEAN_CAM)[None])


class HMR2(nn.Module):
    """HMR 2.0: `backbone` (ViT), `smpl_head` (the transformer decoder
    head), and the body model it poses (numpy, not state)."""

    # a released checkpoint's keys that the asset bundle stands for, and
    # its adversarial prior, which inference does not run
    checkpoint_ignored = ("smpl.", "discriminator.")

    def __init__(self, spec: Hmr2Spec, smpl: SmplModel):
        super().__init__()
        self.spec = spec
        self.backbone = ViT(spec)
        self.smpl_head = SMPLTransformerDecoderHead(spec)
        self.smpl = smpl

    def serving_fold(self, dtype: torch.dtype, use_kernels: bool = True):
        return fold_weights(self, dtype, use_kernels)

    def serving_forward(self, w, consts, crops: torch.Tensor,
                        dtype: torch.dtype):
        return hmr2_forward(self.spec, w, consts, crops, dtype)

    @torch.no_grad()
    def forward(self, crops: torch.Tensor):
        """crops [B, 3, S, S] -> (verts [B, V, 3], joints [B, 24, 3],
        cam_t [B, 3]) in f32 (inference: K3 has no backward); see
        `hmr2_forward`."""
        w, consts = fold_weights(self, torch.float32)
        return hmr2_forward(self.spec, w, consts, crops, torch.float32)


def build_hmr2(assets: GatorAssets, spec: Hmr2Spec = Hmr2Spec(),
               seed: int = 0, device="cuda") -> HMR2:
    """An HMR 2.0 model with seeded weights (the published initialisers:
    ViTPose's trunc-normal 0.02 linears and pos_embed with zero biases,
    LayerNorms (1, 0), the conv's and the decoder's torch defaults, the
    decoder's pos_embedding standard normal; the mean parameters the rest
    pose, zero betas and the camera (0.9, 0, 0), standing in for
    smpl_mean_params.npz), in
    eval mode, on `device`, posing the asset bundle's neutral SMPL."""
    model = HMR2(spec, assets.smpl)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                bound = mod.weight[0].numel() ** -0.5
                mod.weight.uniform_(-bound, bound, generator=gen)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=gen)
        for mod in model.backbone.blocks.modules():
            if isinstance(mod, nn.Linear):
                nn.init.trunc_normal_(mod.weight, std=0.02, generator=gen)
                mod.bias.zero_()
        nn.init.trunc_normal_(model.backbone.pos_embed, std=0.02,
                              generator=gen)
        model.smpl_head.transformer.pos_embedding.normal_(generator=gen)
    return model.eval().to(device)


def fold_weights(model: HMR2, dtype: torch.dtype, use_kernels: bool = True
                 ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """-> (w, consts) for `hmr2_forward`: the state dict in `dtype` (the
    mean parameters stay f32), and the derived tables: the position table
    pos_embed[:, 1:] + pos_embed[:, :1], the decoder's first token
    (to_token_embedding of the zero token, its bias, plus pos_embedding),
    the six layers' to_kv weights stacked into one product, all in
    `dtype`; the body model on the model's device; the attention (K3, or
    its plain version with `use_kernels=False`). In the set-up span
    setup.fold."""
    device = next(model.parameters()).device
    spec = model.spec
    with torch.no_grad(), span("setup.fold", always=True):
        sd = model.state_dict()
        w = {k: v if (k.startswith("smpl_head.init_")
                      or not v.is_floating_point()) else v.to(dtype)
             for k, v in sd.items()}
        pe = sd["backbone.pos_embed"].float()
        dec = "smpl_head.transformer."
        layers = dec + "transformer.layers."
        consts = {
            "pos": (pe[:, 1:] + pe[:, :1]).to(dtype),
            "token0": (sd[dec + "to_token_embedding.bias"].float()
                       + sd[dec + "pos_embedding"].float()[0, 0]
                       ).to(dtype)[None, None],
            "to_kv": torch.cat([sd[layers + f"{i}.1.fn.to_kv.weight"]
                                for i in range(spec.dec_depth)]).to(dtype),
            "smpl": SmplParams.from_model(model.smpl, device),
            "use_kernels": use_kernels,
        }
    return w, consts


def _layer_norm(y, w, p, eps):
    return F.layer_norm(y, y.shape[-1:], w[p + "weight"], w[p + "bias"], eps)


def _linear(y, w, p):
    return F.linear(y, w[p + "weight"], w.get(p + "bias"))


def _patch_embed(spec: Hmr2Spec, w, img: torch.Tensor) -> torch.Tensor:
    """The padded conv (kernel = stride = patch) as one product: the
    patches of the padded image [B * N, 3 * P * P], in the conv weight's
    (channel, row, column) order, against its [C, 3 * P * P] view, plus
    its bias -> contiguous tokens [B, N, C] (a conv's output transposed to
    tokens would leave every later add of the residual stream strided)."""
    b = img.shape[0]
    s, p = spec.patch_size, spec.patch_padding
    hp, wp = spec.grid
    img = F.pad(img, (p, p, p, p))[:, :, :hp * s, :wp * s]
    patches = img.reshape(b, 3, hp, s, wp, s).permute(0, 2, 4, 1, 3, 5)
    weight = w["backbone.patch_embed.proj.weight"]
    return F.linear(patches.reshape(b * hp * wp, -1),
                    weight.reshape(weight.shape[0], -1),
                    w["backbone.patch_embed.proj.bias"]).view(b, hp * wp, -1)


def _backbone(spec: Hmr2Spec, w, consts, x: torch.Tensor) -> torch.Tensor:
    """The 32 blocks and last_norm on tokens x [B, N, C]."""
    b, n, c = x.shape
    h = spec.num_heads
    d = c // h
    for i in range(spec.depth):
        p = f"backbone.blocks.{i}."
        qkv = _linear(_layer_norm(x, w, p + "norm1.", spec.eps), w,
                      p + "attn.qkv.").view(b, n, 3, h, d)
        o = fused_attention_into(*qkv.unbind(2), d ** -0.5,
                                 use_kernel=consts["use_kernels"])
        x = x + _linear(o.view(b, n, c), w, p + "attn.proj.")
        y = _layer_norm(x, w, p + "norm2.", spec.eps)
        x = x + _linear(F.gelu(_linear(y, w, p + "mlp.fc1.")), w,
                        p + "mlp.fc2.")
    return _layer_norm(x, w, "backbone.last_norm.", spec.eps)


def _decoder(spec: Hmr2Spec, w, consts, ctx: torch.Tensor) -> torch.Tensor:
    """The decoder's six layers on the zero token, against the backbone's
    tokens ctx [B, N, C] -> the token [B, dec_dim]."""
    b, n, _ = ctx.shape
    hd, dh, nl = spec.dec_heads, spec.dec_dim_head, spec.dec_depth
    inner = hd * dh
    scale = dh ** -0.5
    use = consts["use_kernels"]
    # every layer's to_kv in one product: [B, N, layer, k|v, head, D]
    kv = F.linear(ctx, consts["to_kv"]).view(b, n, nl, 2, hd, dh)
    x = consts["token0"].expand(b, 1, spec.dec_dim)
    for i in range(nl):
        p = f"smpl_head.transformer.transformer.layers.{i}."
        y = _layer_norm(x, w, p + "0.norm.", spec.dec_eps)
        qkv = F.linear(y, w[p + "0.fn.to_qkv.weight"]).view(b, 1, 3, hd, dh)
        o = fused_attention_into(*qkv.unbind(2), scale, use_kernel=use)
        x = x + _linear(o.view(b, 1, inner), w, p + "0.fn.to_out.0.")
        y = _layer_norm(x, w, p + "1.norm.", spec.dec_eps)
        q = F.linear(y, w[p + "1.fn.to_q.weight"]).view(b, 1, hd, dh)
        o = fused_attention_into(q, kv[:, :, i, 0], kv[:, :, i, 1], scale,
                                 use_kernel=use)
        x = x + _linear(o.view(b, 1, inner), w, p + "1.fn.to_out.0.")
        y = _layer_norm(x, w, p + "2.norm.", spec.dec_eps)
        x = x + _linear(F.gelu(_linear(y, w, p + "2.fn.net.0.")), w,
                        p + "2.fn.net.3.")
    return x[:, 0]


def hmr2_forward(spec: Hmr2Spec, w: Dict[str, torch.Tensor], consts,
                 crops: torch.Tensor, dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """crops [B, 3, S, S] -> (verts [B, V, 3], joints [B, 24, 3], cam_t
    [B, 3]), f32, metres; products in `dtype`, the head's sums, the
    rotations and SMPL in f32. In the spans serve.hmr_patch,
    serve.hmr_vit, serve.hmr_decoder, serve.hmr_smpl."""
    b = crops.shape[0]
    s = spec.image_size
    if crops.shape[1:] != (3, s, s):
        raise ValueError(f"HMR 2.0 takes crops [B, 3, {s}, {s}], not "
                         f"{tuple(crops.shape)}")
    x0 = (spec.image_size - spec.img_w) // 2
    with span("serve.hmr_patch"):
        x = _patch_embed(spec, w, crops[..., x0:x0 + spec.img_w].to(dtype))
        x += consts["pos"]                                    # [B, N, C]

    with span("serve.hmr_vit"):
        ctx = _backbone(spec, w, consts, x)

    with span("serve.hmr_decoder"):
        tok = _decoder(spec, w, consts, ctx)
        hd = "smpl_head."
        pose6d = _linear(tok, w, hd + "decpose.").float() \
            + w[hd + "init_body_pose"]
        betas = _linear(tok, w, hd + "decshape.").float() \
            + w[hd + "init_betas"]
        cam = _linear(tok, w, hd + "deccam.").float() + w[hd + "init_cam"]
        rot = rot6d_to_rotmat(pose6d.view(b, SMPL_JOINTS, 6))
        cam_t = torch.stack([cam[:, 1], cam[:, 2], 2 * spec.focal_length
                             / (spec.image_size * cam[:, 0] + 1e-9)], -1)

    with span("serve.hmr_smpl"):
        verts, joints = smpl_forward_rotmat(consts["smpl"], rot, betas)
    return verts, joints, cam_t
