"""MotionBERT's mesh-recovery model: 2D skeleton clips -> SMPL meshes.

Zhu et al., "MotionBERT: A Unified Perspective on Learning Human Motion
Representations", ICCV 2023 (arXiv 2210.06551); code at
github.com/Walter0807/MotionBERT: the DSTformer backbone
(lib/model/DSTformer.py) and the mesh head (lib/model/model_mesh.py,
`MeshRegressor` over `SMPLRegressor`), at the model settings of
configs/mesh/MB_ft_pw3d.yaml (`MotionBertSpec`'s defaults).

Clips [N, T, 17, 3] of H36M joints (x, y in a [-1, 1] crop, confidence)
-> (verts [N, T, 6890, 3], kp3d [N, T, 17, 3]): an SMPL mesh a frame and
its H36M joints (the asset bundle's `j_regressor_h36m`), in metres.
MotionBERT multiplies both by 1000; that is a unit, left out here.

The model, a token x of width C a (frame, joint):
  * embed: x = joints_embed(p) + pos_embed[j] + temp_embed[t];
  * each of `depth` depths runs two Blocks on the same x, one spatial
    then temporal (`blocks_st`), one temporal then spatial (`blocks_ts`),
    and fuses them with a learned per-token gate: a = softmax(ts_attn[i](
    [x_st, x_ts])), x = a0 x_st + a1 x_ts;
  * a Block's half is pre-LN attention and a pre-LN MLP (fc2(GELU(fc1)),
    exact GELU), each added to x; spatial attention runs over the 17
    joints of a frame, temporal over the T frames of a joint;
  * rep = tanh(pre_logits.fc(norm(x)));
  * the head (eval: no dropout, BatchNorm on running statistics): a 6D
    rotation a SMPL joint a frame, init_pose + head_pose(ReLU(bn1(fc1(
    rep of the frame's 17 joints)))), in the SPIN layout
    (`bodymodel.rot6d_to_rotmat_spin`); betas a clip, init_shape +
    head_shape(ReLU(bn2(fc2(rep averaged over the clip's frames))));
  * SMPL from the rotation matrices (`bodymodel.smpl_forward_rotmat`,
    smplx's pose2rot=False), no translation; kp3d = J_regressor_h36m
    verts.

The modules carry the published names, so that a released checkpoint's
state dict loads through `train.checkpoint.load_weights`; its SMPL layer's
tables (`head.smpl.*`) are left out there, as the body model is the asset
bundle's. `backbone.head` (the pretraining's 3D output) is held for the
same reason and is not on the mesh path.

`mesh_forward` is the model's function over the weights `fold_weights`
derives once: the serving call (`serving.make_serving_fn`, bf16, through
the model's `serving_fold` and `serving_forward`) and the module's own
`forward` (f32) run it. The backbone and head run in the
serving type, LayerNorm statistics in f32 (PyTorch's LayerNorm
accumulates a bf16 input in f32), BatchNorm in f32, SMPL in f32. Both
attentions run on K3 (`nn.fused_attention_into`) on CUDA, on its plain
version on the CPU, reading the qkv product's strided views in place: the
spatial one as [frames, 17, H, D], the temporal one as [clips, joints, T,
H, D] (K3's second batch dimension), its output written straight into the
[clips, T, joints, C] token layout. A call is the spans serve.mb_embed,
serve.mb_blocks, serve.mb_head and serve.mb_smpl.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..assets.bundle import GatorAssets
from ..assets.smpl_assets import SmplModel
from ..bodymodel import SmplParams, rot6d_to_rotmat_spin, smpl_forward_rotmat
from ..nn import fused_attention_into
from ..profiling import span

SMPL_JOINTS = 24
SHAPE_DIM = 10
BN_EPS = 1e-5                    # nn.BatchNorm1d's default
# the 6D rest rotation in the SPIN layout: [[1, 0], [0, 1], [0, 0]]
REST_6D = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class MotionBertSpec:
    """MotionBERT's model settings (MB_ft_pw3d.yaml; the LayerNorm eps of
    DSTformer.py's `load_backbone`)."""
    dim_in: int = 3
    dim_feat: int = 512
    dim_rep: int = 512
    depth: int = 5
    num_heads: int = 8
    mlp_ratio: float = 2.0
    maxlen: int = 243
    num_joints: int = 17
    hidden_dim: int = 1024
    eps: float = 1e-6


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)    # qkv_bias: True
        self.proj = nn.Linear(dim, dim)


class Block(nn.Module):
    """One stream's Block: `stage_st` runs its spatial half first,
    `stage_ts` its temporal half."""

    def __init__(self, spec: MotionBertSpec, st_mode: str):
        super().__init__()
        c = spec.dim_feat
        hid = int(c * spec.mlp_ratio)
        self.st_mode = st_mode
        for m in ("s", "t"):
            setattr(self, f"norm1_{m}", nn.LayerNorm(c, eps=spec.eps))
            setattr(self, f"attn_{m}", Attention(c))
            setattr(self, f"norm2_{m}", nn.LayerNorm(c, eps=spec.eps))
            setattr(self, f"mlp_{m}", Mlp(c, hid))


class DSTformer(nn.Module):
    def __init__(self, spec: MotionBertSpec):
        super().__init__()
        c = spec.dim_feat
        self.joints_embed = nn.Linear(spec.dim_in, c)
        self.blocks_st = nn.ModuleList(Block(spec, "stage_st")
                                       for _ in range(spec.depth))
        self.blocks_ts = nn.ModuleList(Block(spec, "stage_ts")
                                       for _ in range(spec.depth))
        self.norm = nn.LayerNorm(c, eps=spec.eps)
        self.pre_logits = nn.Sequential()
        self.pre_logits.add_module("fc", nn.Linear(c, spec.dim_rep))
        self.pre_logits.add_module("act", nn.Tanh())
        self.head = nn.Linear(spec.dim_rep, 3)
        self.temp_embed = nn.Parameter(torch.zeros(1, spec.maxlen, 1, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, spec.num_joints, c))
        self.ts_attn = nn.ModuleList(nn.Linear(2 * c, 2)
                                     for _ in range(spec.depth))


class SMPLRegressor(nn.Module):
    def __init__(self, spec: MotionBertSpec):
        super().__init__()
        feat = spec.num_joints * spec.dim_rep
        self.fc1 = nn.Linear(feat, spec.hidden_dim)
        self.fc2 = nn.Linear(feat, spec.hidden_dim)
        self.bn1 = nn.BatchNorm1d(spec.hidden_dim)
        self.bn2 = nn.BatchNorm1d(spec.hidden_dim)
        self.head_pose = nn.Linear(spec.hidden_dim, SMPL_JOINTS * 6)
        self.head_shape = nn.Linear(spec.hidden_dim, SHAPE_DIM)
        # smpl_mean_params.npz's pose (6D, SPIN layout) and shape
        self.register_buffer("init_pose", torch.tensor(
            REST_6D * SMPL_JOINTS)[None])
        self.register_buffer("init_shape", torch.zeros(1, SHAPE_DIM))


class MeshRegressor(nn.Module):
    """MotionBERT's mesh model: `backbone` (DSTformer), `head`
    (SMPLRegressor), and the body model it poses (numpy, not state)."""

    # a released checkpoint's keys that the asset bundle stands for
    checkpoint_ignored = ("head.smpl.",)

    def __init__(self, spec: MotionBertSpec, smpl: SmplModel,
                 j_regressor_h36m: np.ndarray):
        super().__init__()
        self.spec = spec
        self.backbone = DSTformer(spec)
        self.head = SMPLRegressor(spec)
        self.smpl = smpl
        self.j_regressor_h36m = np.asarray(j_regressor_h36m, np.float32)

    def serving_fold(self, dtype: torch.dtype, use_kernels: bool = True):
        return fold_weights(self, dtype, use_kernels)

    def serving_forward(self, w, consts, clips: torch.Tensor,
                        dtype: torch.dtype):
        return mesh_forward(self.spec, w, consts, clips, dtype)

    @torch.no_grad()
    def forward(self, clips: torch.Tensor):
        """clips [N, T, J, 3] -> (verts [N, T, V, 3], kp3d [N, T, 17, 3])
        in f32 (inference: K3 has no backward); see `mesh_forward`."""
        w, consts = fold_weights(self, torch.float32)
        return mesh_forward(self.spec, w, consts, clips, torch.float32)


def _trunc_normal(t: torch.Tensor, std: float, gen: torch.Generator):
    nn.init.trunc_normal_(t, std=std, a=-2.0, b=2.0, generator=gen)


def _torch_default(lin: nn.Linear, gen: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(lin.in_features)
    lin.weight.uniform_(-bound, bound, generator=gen)
    lin.bias.uniform_(-bound, bound, generator=gen)


def init_motionbert_(model: MeshRegressor, gen: torch.Generator
                     ) -> MeshRegressor:
    """MotionBERT's initialisation, drawn from `gen`: the backbone's
    linears trunc-normal 0.02 with zero biases, LayerNorms (1, 0), the
    two embeddings trunc-normal 0.02, ts_attn weight 0 and bias 0.5
    (DSTformer.__init__, `_init_weights`); the head's fc1/fc2 torch's
    default, head_pose/head_shape xavier at gain 0.01
    (SMPLRegressor.__init__); init_pose the rest pose and init_shape 0,
    standing in for smpl_mean_params.npz (a download)."""
    bb, hd = model.backbone, model.head
    with torch.no_grad():
        for mod in bb.modules():
            if isinstance(mod, nn.Linear):
                _trunc_normal(mod.weight, 0.02, gen)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        _trunc_normal(bb.temp_embed, 0.02, gen)
        _trunc_normal(bb.pos_embed, 0.02, gen)
        for lin in bb.ts_attn:
            lin.weight.zero_()
            lin.bias.fill_(0.5)
        for lin in (hd.fc1, hd.fc2, hd.head_pose, hd.head_shape):
            _torch_default(lin, gen)
        for lin in (hd.head_pose, hd.head_shape):
            nn.init.xavier_uniform_(lin.weight, gain=0.01, generator=gen)
        for bn in (hd.bn1, hd.bn2):
            bn.reset_parameters()
        hd.init_pose.copy_(torch.tensor(REST_6D * SMPL_JOINTS)[None])
        hd.init_shape.zero_()
    return model


def build_motionbert_mesh(assets: GatorAssets,
                          spec: MotionBertSpec = MotionBertSpec(),
                          seed: int = 0, device="cuda") -> MeshRegressor:
    """A MotionBERT mesh model with seeded weights (MotionBERT's init), in
    eval mode, on `device`, posing the asset bundle's neutral SMPL."""
    if assets.j_regressor_h36m.shape[0] != spec.num_joints:
        raise ValueError(f"MotionBERT takes {spec.num_joints} H36M joints; "
                         f"the bundle regresses "
                         f"{assets.j_regressor_h36m.shape[0]}")
    model = MeshRegressor(spec, assets.smpl, assets.j_regressor_h36m)
    init_motionbert_(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)


def fold_weights(model: MeshRegressor, dtype: torch.dtype,
                 use_kernels: bool = True
                 ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """-> (w, consts) for `mesh_forward`: the state dict in `dtype`
    (BatchNorm's statistics, init_pose and init_shape stay f32), and the
    derived tables: the position table pos_embed[j] + temp_embed[t]
    [maxlen, J, C] in `dtype`, each BatchNorm as an f32 scale and shift,
    the body model on the model's device, the attention (K3, or its plain
    version with `use_kernels=False`). In the set-up span setup.fold."""
    device = next(model.parameters()).device
    with torch.no_grad(), span("setup.fold", always=True):
        sd = model.state_dict()
        keep = ("running_", "init_pose", "init_shape")
        w = {k: v if (any(s in k for s in keep)
                      or not v.is_floating_point()) else v.to(dtype)
             for k, v in sd.items()}
        bb = "backbone."
        pos = (sd[bb + "temp_embed"][0, :, 0][:, None]
               + sd[bb + "pos_embed"][0][None]).to(dtype)

        def bn(p):
            scale = sd[p + "weight"].float() * torch.rsqrt(
                sd[p + "running_var"].float() + BN_EPS)
            return scale, sd[p + "bias"].float() - \
                sd[p + "running_mean"].float() * scale

        consts = {
            "pos": pos, "bn1": bn("head.bn1."), "bn2": bn("head.bn2."),
            "smpl": SmplParams.from_model(model.smpl, device),
            "j_h36m": torch.as_tensor(model.j_regressor_h36m,
                                      device=device),
            "use_kernels": use_kernels,
        }
    return w, consts


def _layer_norm(y, w, p, eps):
    return F.layer_norm(y, y.shape[-1:], w[p + "weight"], w[p + "bias"], eps)


def _linear(y, w, p):
    return F.linear(y, w[p + "weight"], w[p + "bias"])


def _attention(spec: MotionBertSpec, w, consts, p: str, y: torch.Tensor,
               mode: str) -> torch.Tensor:
    """Attention(mode) on y [N, T, J, C] (DSTformer.py `Attention`):
    spatial ("s") over the J joints of a frame, temporal ("t") over the T
    frames of a joint; -> proj(softmax(q kᵀ / sqrt(D)) v)."""
    n, t, j, c = y.shape
    h = spec.num_heads
    d = c // h
    qkv = _linear(y, w, p + "qkv.").view(n, t, j, 3, h, d)
    q, k, v = qkv.unbind(3)                       # [N, T, J, H, D] views
    if mode == "s":
        q, k, v = (z.view(n * t, j, h, d) for z in (q, k, v))
        out = fused_attention_into(q, k, v, d ** -0.5,
                                   use_kernel=consts["use_kernels"])
    else:
        q, k, v = (z.permute(0, 2, 1, 3, 4) for z in (q, k, v))
        out = torch.empty((n, t, j, h, d), dtype=y.dtype, device=y.device)
        fused_attention_into(q, k, v, d ** -0.5, out.permute(0, 2, 1, 3, 4),
                             use_kernel=consts["use_kernels"])
    return _linear(out.view(n, t, j, c), w, p + "proj.")


def _block(spec: MotionBertSpec, w, consts, p: str, x: torch.Tensor,
           order: Tuple[str, str]) -> torch.Tensor:
    for m in order:
        x = x + _attention(spec, w, consts, p + f"attn_{m}.",
                           _layer_norm(x, w, p + f"norm1_{m}.", spec.eps), m)
        y = _layer_norm(x, w, p + f"norm2_{m}.", spec.eps)
        x = x + _linear(F.gelu(_linear(y, w, p + f"mlp_{m}.fc1.")), w,
                        p + f"mlp_{m}.fc2.")
    return x


def mesh_forward(spec: MotionBertSpec, w: Dict[str, torch.Tensor], consts,
                 clips: torch.Tensor, dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """clips [N, T, J, 3] -> (verts [N, T, V, 3], kp3d [N, T, 17, 3]), f32,
    metres; the backbone and head in `dtype`, SMPL in f32. In the spans
    serve.mb_embed, serve.mb_blocks, serve.mb_head, serve.mb_smpl."""
    n, t, j, _ = clips.shape
    if t > spec.maxlen or j != spec.num_joints:
        raise ValueError(f"MotionBERT takes clips of at most {spec.maxlen} "
                         f"frames of {spec.num_joints} joints, not "
                         f"{tuple(clips.shape)}")
    bb, hd = "backbone.", "head."
    with span("serve.mb_embed"):
        x = _linear(clips.to(dtype), w, bb + "joints_embed.") \
            + consts["pos"][:t]

    with span("serve.mb_blocks"):
        for i in range(spec.depth):
            x_st = _block(spec, w, consts, bb + f"blocks_st.{i}.", x,
                          ("s", "t"))
            x_ts = _block(spec, w, consts, bb + f"blocks_ts.{i}.", x,
                          ("t", "s"))
            a = torch.softmax(_linear(torch.cat([x_st, x_ts], -1), w,
                                      bb + f"ts_attn.{i}."), -1)
            x = x_st * a[..., 0:1] + x_ts * a[..., 1:2]
        rep = torch.tanh(_linear(_layer_norm(x, w, bb + "norm.", spec.eps),
                                 w, bb + "pre_logits.fc."))

    with span("serve.mb_head"):
        def bn_relu(z, which):
            scale, shift = consts[which]
            return torch.relu(z.float() * scale + shift).to(dtype)

        feat = rep.reshape(n, t, -1)                        # [N, T, J*C]
        hp = bn_relu(_linear(feat.reshape(n * t, -1), w, hd + "fc1."), "bn1")
        pose6d = _linear(hp, w, hd + "head_pose.").float() \
            + w[hd + "init_pose"]
        hs = bn_relu(_linear(feat.mean(1), w, hd + "fc2."), "bn2")
        betas = _linear(hs, w, hd + "head_shape.").float() \
            + w[hd + "init_shape"]

    with span("serve.mb_smpl"):
        rot = rot6d_to_rotmat_spin(pose6d.reshape(n * t, SMPL_JOINTS, 6))
        betas = betas[:, None].expand(n, t, SHAPE_DIM).reshape(n * t, -1)
        verts, _ = smpl_forward_rotmat(consts["smpl"], rot, betas)
        kp3d = torch.einsum("jv,bvc->bjc", consts["j_h36m"], verts)
    return (verts.reshape(n, t, -1, 3),
            kp3d.reshape(n, t, consts["j_h36m"].shape[0], 3))
