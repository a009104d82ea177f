"""The benchmark's own count of MotionBERT's mesh model's work, from shapes
(the conventions of core/counts.py: a product of [m, k] and [k, n] is
2*m*k*n operations, counted once; elementwise work, softmax, norms and
GELU are not counted; each input byte read once and each output written
once). Every width comes from the configuration file.

Per token (a frame's joint), a Block (one of `depth` per stream, two
streams) does qkv, proj, fc1 and fc2 for its spatial and its temporal
half: 2 * (3C^2 + C^2 + 2 C * hidden) multiply-adds = 4.19 M at C = 512,
hidden 1024. The attentions' score and PV products add 2 * J * C
(spatial, over the J joints) and 2 * T * C (temporal, over the T frames)
a token a Block. The head works a frame (fc1, head_pose) and a clip (fc2,
head_shape, spread over its T frames); SMPL a frame: the shape and pose
blend shapes, the rest joints, the skinning weights' product, the
vertices' transforms and the H36M joints.
"""
from __future__ import annotations

from .counts import mm

SMPL_JOINTS = 24
SHAPE_DIM = 10
POSE_BLEND = 9 * (SMPL_JOINTS - 1)


def dims(cfg: dict, t: int = None) -> dict:
    return {"c": cfg["dim_feat"], "rep": cfg["dim_rep"],
            "depth": cfg["depth"], "heads": cfg["num_heads"],
            "hid": int(cfg["dim_feat"] * cfg["mlp_ratio"]),
            "j": cfg["num_joints"], "t": t or cfg["clip_len"],
            "hidden": cfg["hidden_dim"], "v": cfg["smpl_vertices"],
            "nj": cfg.get("smpl_joints", SMPL_JOINTS)}


def block_dense(d: dict) -> int:
    """A Block's linears, a token (spatial and temporal halves)."""
    c, hid = d["c"], d["hid"]
    return 2 * (mm(1, c, 3 * c) + mm(1, c, c) + mm(1, c, hid)
                + mm(1, hid, c))


def attention_spatial(d: dict) -> int:
    """QKᵀ and PV of the spatial attention, a token (over J keys)."""
    return 2 * mm(1, d["c"], d["j"])


def attention_temporal(d: dict) -> int:
    """QKᵀ and PV of the temporal attention, a token (over T keys)."""
    return 2 * mm(1, d["c"], d["t"])


def backbone_token(d: dict) -> int:
    """The DSTformer's products a token: embed, 2 * depth Blocks, the
    depth gates, pre_logits."""
    c = d["c"]
    blocks = 2 * d["depth"] * (block_dense(d) + attention_spatial(d)
                               + attention_temporal(d))
    return (mm(1, 3, c) + blocks + d["depth"] * mm(1, 2 * c, 2)
            + mm(1, c, d["rep"]))


def head_frame(d: dict) -> int:
    """SMPLRegressor a frame: fc1 and head_pose; fc2 and head_shape a
    clip, over its T frames."""
    feat = d["j"] * d["rep"]
    per_clip = mm(1, feat, d["hidden"]) + mm(1, d["hidden"], SHAPE_DIM)
    return (mm(1, feat, d["hidden"]) + mm(1, d["hidden"], 6 * d["nj"])
            + per_clip // d["t"])


def smpl_frame(d: dict) -> int:
    """SMPL from rotation matrices and the H36M joints, a frame."""
    v, nj = d["v"], d["nj"]
    return (mm(1, SHAPE_DIM, 3 * v) + mm(1, POSE_BLEND, 3 * v)
            + mm(nj, v, 3) + mm(v, nj, 12) + v * 2 * 9
            + nj * 2 * 4 * 4 * 4 + mm(d["j"], v, 3))


def frame(d: dict) -> int:
    """The whole model's products a frame."""
    return d["j"] * backbone_token(d) + head_frame(d) + smpl_frame(d)


def k3_ops(d: dict, clips: int) -> int:
    """K3's products a call: each of 2 * depth Blocks runs one spatial and
    one temporal launch over every token."""
    tokens = clips * d["t"] * d["j"]
    return 2 * d["depth"] * tokens * (attention_spatial(d)
                                      + attention_temporal(d))


def k3_bytes(d: dict, clips: int, act: int = 2) -> int:
    """K3's bytes a call: q, k and v read and out written, [tokens, C]
    each, a launch; 2 launches (spatial, temporal) a Block."""
    tokens = clips * d["t"] * d["j"]
    return 2 * d["depth"] * 2 * 4 * tokens * d["c"] * act


def k3_launches(d: dict) -> int:
    return 2 * 2 * d["depth"]
