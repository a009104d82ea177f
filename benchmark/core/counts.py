"""The benchmark's own count of GATOR's work, from shapes.

A product of an [m, k] and a [k, n] operand is 2*m*k*n operations, counted
once, whatever the implementation recomputes. Elementwise work (norms,
softmax, GELU, dropout, masks) is not counted: the peak it is held
against is the tensor cores'. A training step's backward takes, for
every forward product, one product for each operand's gradient (input
and weight, or both activations), so a step is 3x the forward; nothing
recomputed is counted. Bytes: each input of a function read once and each
output written once.

Every width comes from the configuration file (`cfg`); J is its joint
count, so the COCO-input model (J = 19) counts its own tiles.
"""
from __future__ import annotations

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense): the card's peaks at
# its full 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def dims(cfg: dict) -> dict:
    g, m = cfg["gat"], cfg["mdr"]
    return {"j": cfg["num_joint"], "c": g["embed_dim"], "depth": g["depth"],
            "heads": g["num_heads"], "mlp": g["mlp_ratio"],
            "shrink": g["xfeat_shrink"], "mc": m["embed_dim"],
            "mheads": m["num_heads"], "layers": m["layers"],
            "mmlp": m["mlp_ratio"], "nv": m["coarse_vertices"],
            "nf": m["full_vertices"], "basis": m["num_basis"],
            "alpha": m["alpha"]}


def mm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


# -- forward products per sample ---------------------------------------


def gat_block(d: dict) -> int:
    """One GAT block: bias attention, MGCN, XFeat's two hop rings, MLP."""
    j, c = d["j"], d["c"]
    ring1 = c // d["shrink"]
    hid = int(c * d["mlp"])
    return (mm(j, c, 3 * c) + 2 * mm(j, c, j)           # qkv; QK^T and PV
            + mm(j, c, c)                               # proj
            + 2 * mm(j, c, c) + mm(j, j, c)             # MGCN W0, W1; A_off
            + mm(j, c, c) + mm(j, c, ring1)             # XFeat rings
            + mm(j, j, c) + mm(j, j, ring1)             # ring sums
            + mm(j, c + ring1, c)                       # linearback
            + mm(j, c, hid) + mm(j, hid, c))            # MLP


def gat_trunk(d: dict) -> int:
    return d["depth"] * gat_block(d)


def gat_outside_trunk(d: dict) -> int:
    """The lifter's embeds (two GraphLinears) and its output linear."""
    j, c = d["j"], d["c"]
    return mm(j, 2, 64) + mm(j, 64, c) + mm(1, j * c, 3 * j)


def lbf_layer(d: dict) -> int:
    """One LBF layer: joint->vertex cross attention, MLP, vertex
    self-attention."""
    j, nv, c = d["j"], d["nv"], d["mc"]
    hid = int(c * d["mmlp"])
    cross = (mm(nv, c, c) + 2 * mm(j, c, c)             # q; k, v
             + 2 * mm(nv, c, j) + mm(nv, c, c))         # QK^T, PV; proj
    mlp = mm(nv, c, hid) + mm(nv, hid, c)
    self_att = 3 * mm(nv, c, c) + 2 * mm(nv, c, nv) + mm(nv, c, c)
    return cross + mlp + self_att


def lbf_stack(d: dict) -> int:
    return d["layers"] * lbf_layer(d)


def mdr_outside_stack(d: dict) -> int:
    """Token build, the A/B/C head and the 431 -> 6890 upsample. A
    length-3 Conv1d with padding 1 over 3 positions has 7 taps that read
    an input (2 of the 9 read the zero padding)."""
    j, nv, c, nf, k = d["j"], d["nv"], d["mc"], d["nf"], d["basis"]
    tokens = mm(j, 5 + d["c"], c) + mm(nv, 6, c)
    head = (mm(nv, c, k + 3) + mm(nv, c, 3) + (mm(nv, c, 1) if d["alpha"]
                                               else 0)
            + 7 * 2 * k * nv                            # bias_conv1d
            + mm(nv, k, 3)                              # softmax(A) @ B
            + 7 * 2 * nf * nv)                          # upsample
    return tokens + head


def model_forward(d: dict) -> int:
    """Forward products of one pose (the hop/path bias, which depends on
    no input, is left out)."""
    return (gat_outside_trunk(d) + gat_trunk(d) + mdr_outside_stack(d)
            + lbf_stack(d))


def train_step(d: dict) -> int:
    return 3 * model_forward(d)


# -- parameters and bytes ----------------------------------------------


def gat_block_params(d: dict) -> int:
    j, c = d["j"], d["c"]
    ring1 = c // d["shrink"]
    hid = int(c * d["mlp"])
    return (c * 3 * c + 3 * c + c * c + c                # qkv, proj
            + 2 * c * c + j * c + j * j + c              # MGCN
            + c * c + c + c * ring1 + ring1              # XFeat rings
            + (c + ring1) * c + c                        # linearback
            + 4 * c                                      # two LayerNorms
            + c * hid + hid + hid * c + c)               # MLP


def lbf_layer_params(d: dict) -> int:
    c = d["mc"]
    hid = int(c * d["mmlp"])
    return (3 * c * c + c * c + c + 4 * c                # cross q, k, v, proj
            + c * hid + hid + hid * c + c                # MLP
            + 2 * c + 4 * (c * c + c))                   # std LN, 4 linears


def k1_bytes(d: dict, b: int, act: int = 2) -> int:
    """K1: x in, x out, the six blocks' weights, the [H, J, J] f32 bias."""
    j, c = d["j"], d["c"]
    return (2 * b * j * c * act + d["depth"] * gat_block_params(d) * act
            + d["heads"] * j * j * 4)


def k2_bytes(d: dict, b: int, act: int = 2) -> int:
    """K2: vertex tokens in and out, joint tokens in, the weights."""
    j, nv, c = d["j"], d["nv"], d["mc"]
    return ((2 * b * nv * c + b * j * c) * act
            + d["layers"] * lbf_layer_params(d) * act)


def k5_bytes(d: dict, b: int, act: int = 2) -> int:
    """K5 forward and backward: x and the output's gradient in, the
    output and dx out (act bytes), the f32 master weights in and their
    f32 gradients out."""
    j, c = d["j"], d["c"]
    return (4 * b * j * c * act + 2 * d["depth"] * gat_block_params(d) * 4
            + 2 * d["heads"] * j * j * 4)


def k4_bytes(d: dict, b: int, act: int = 2) -> int:
    """K4 forward and backward: vertex and joint tokens and the output's
    gradient in, the output, dx and the joints' gradient out, the f32
    weights in and their gradients out."""
    j, nv, c = d["j"], d["nv"], d["mc"]
    return ((4 * b * nv * c + 2 * b * j * c) * act
            + 2 * d["layers"] * lbf_layer_params(d) * 4)


def bound_s(ops: int, nbytes: int) -> tuple:
    """-> (the least time the card could take, "ops" or "bytes": which of
    the two bounds it)."""
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def roofline_pct(ops: int, nbytes: int, measured_s: float) -> float:
    return 100.0 * bound_s(ops, nbytes)[0] / measured_s
