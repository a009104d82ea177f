"""The benchmark's own count of HMR 2.0's work, from shapes (the
conventions of core/counts.py: a product of [m, k] and [k, n] is 2*m*k*n
operations, counted once; elementwise work, softmax, norms and GELU are
not counted; each input byte read once and each output written once).
Every width comes from the configuration file.

A crop is N = 192 patch tokens of width C = 1280. The patch embed is a
product of [N, 3*16*16] and [3*16*16, C]. A block does qkv, proj, fc1 and
fc2 (2 N (3C^2 + C^2 + 2 C * 4C) = 7.55 GFLOP) and its attention's score
and PV products (4 N^2 C = 0.189 GFLOP); 32 blocks and the patch embed
make 247.9 GFLOP. The decoder works one token: a layer's self-attention
(qkv, its one score and PV, to_out), cross-attention (to_q, to_kv over
the N context tokens, the scores and PV against N keys, to_out) and
feed-forward, 0.51 GFLOP a layer, nearly all of it to_kv; the readouts
and SMPL (the shape and pose blend shapes, the rest joints, the skinning
weights' product and the vertices' transforms) add 15 MFLOP. 251 GFLOP a
crop in all.
"""
from __future__ import annotations

from .counts import mm
from .mb_counts import POSE_BLEND, SHAPE_DIM, SMPL_JOINTS

READOUT = 6 * SMPL_JOINTS + SHAPE_DIM + 3


def dims(cfg: dict) -> dict:
    ps, pad = cfg["patch_size"], cfg["patch_padding"]
    hp = (cfg["img_h"] + 2 * pad - ps) // ps + 1
    wp = (cfg["img_w"] + 2 * pad - ps) // ps + 1
    c = cfg["embed_dim"]
    return {"c": c, "n": hp * wp, "patch_in": 3 * ps * ps,
            "depth": cfg["depth"], "heads": cfg["num_heads"],
            "hid": int(c * cfg["mlp_ratio"]), "dim": cfg["dec_dim"],
            "dec_depth": cfg["dec_depth"],
            "inner": cfg["dec_heads"] * cfg["dec_dim_head"],
            "dim_head": cfg["dec_dim_head"],
            "mlp": cfg["dec_mlp_dim"], "ctx": cfg["context_dim"],
            "img_h": cfg["img_h"], "img_w": cfg["img_w"],
            "v": cfg["smpl_vertices"],
            "nj": cfg.get("smpl_joints", SMPL_JOINTS)}


def block(d: dict) -> int:
    """A ViT block's products, a crop: qkv, the attention, proj, MLP."""
    n, c, hid = d["n"], d["c"], d["hid"]
    return (mm(n, c, 3 * c) + 2 * mm(n, c, n) + mm(n, c, c)
            + mm(n, c, hid) + mm(n, hid, c))


def backbone(d: dict) -> int:
    """The patch embed and the blocks, a crop."""
    return mm(d["n"], d["patch_in"], d["c"]) + d["depth"] * block(d)


def decoder_layer(d: dict) -> int:
    dim, inner, n = d["dim"], d["inner"], d["n"]
    sa = mm(1, dim, 3 * inner) + 2 * mm(1, inner, 1) + mm(1, inner, dim)
    ca = (mm(1, dim, inner) + mm(n, d["ctx"], 2 * inner)
          + 2 * mm(1, inner, n) + mm(1, inner, dim))
    ff = mm(1, dim, d["mlp"]) + mm(1, d["mlp"], dim)
    return sa + ca + ff


def decoder(d: dict) -> int:
    """The decoder's layers and the three readouts, a crop."""
    return d["dec_depth"] * decoder_layer(d) + mm(1, d["dim"], READOUT)


def smpl_crop(d: dict) -> int:
    """SMPL from rotation matrices, a crop."""
    v, nj = d["v"], d["nj"]
    return (mm(1, SHAPE_DIM, 3 * v) + mm(1, POSE_BLEND, 3 * v)
            + mm(nj, v, 3) + mm(v, nj, 12) + v * 2 * 9
            + nj * 2 * 4 * 4 * 4)


def crop(d: dict) -> int:
    """The whole model's products a crop."""
    return backbone(d) + decoder(d) + smpl_crop(d)


def backbone_params(d: dict) -> int:
    """The backbone's parameters: the patch conv, pos_embed, the blocks'
    linears and LayerNorms, last_norm."""
    c, hid = d["c"], d["hid"]
    blk = (c * 3 * c + 3 * c + c * c + c + c * hid + hid + hid * c + c
           + 4 * c)
    return (d["patch_in"] * c + c + (d["n"] + 1) * c + d["depth"] * blk
            + 2 * c)


def backbone_bytes(d: dict, crops: int, act: int = 2) -> int:
    """The backbone's bytes a call: its weights in the served type, the
    sliced crops read (f32), the tokens written."""
    return (backbone_params(d) * act + crops * 3 * d["img_h"] * d["img_w"] * 4
            + crops * d["n"] * d["c"] * act)


def k3_ops(d: dict, crops: int) -> int:
    """K3's products a call: the backbone's attentions (scores and PV over
    N keys, C wide), the decoder's cross-attentions (one query against N
    keys) and self-attentions (one key)."""
    n = d["n"]
    return crops * (d["depth"] * 2 * mm(n, d["c"], n)
                    + d["dec_depth"] * 2 * (mm(1, d["inner"], n)
                                            + mm(1, d["inner"], 1)))


def k3_launch_bytes(d: dict, crops: int, act: int = 2) -> dict:
    """K3's bytes a launch, by kind: each launch's q, k and v read and out
    written: the backbone's ("vit") [N, C] each; the cross-attention's
    ("cross") k and v [N, inner], q and out [1, inner]; the
    self-attention's ("self") four [1, inner]."""
    n, inner = d["n"], d["inner"]
    return {"vit": crops * act * 4 * n * d["c"],
            "cross": crops * act * (2 * n * inner + 2 * inner),
            "self": crops * act * 4 * inner}


def k3_bytes(d: dict, crops: int, act: int = 2) -> int:
    """K3's bytes a call: `depth` backbone launches, `dec_depth` cross-
    and self-attentions."""
    per = k3_launch_bytes(d, crops, act)
    return (d["depth"] * per["vit"]
            + d["dec_depth"] * (per["cross"] + per["self"]))

