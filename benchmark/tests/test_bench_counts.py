"""The benchmark's operation and byte counts against hand counts."""
import pytest

from benchmark.core import counts, spec

SMALL = {"num_joint": 17,
         "gat": {"embed_dim": 16, "depth": 2, "num_heads": 2,
                 "mlp_ratio": 4.0, "xfeat_shrink": 8},
         "mdr": {"embed_dim": 8, "num_heads": 2, "layers": 2,
                 "mlp_ratio": 4.0, "coarse_vertices": 5,
                 "full_vertices": 7, "num_basis": 2, "alpha": False}}


def hand_gat_block(j):
    # C=16, ring widths 16 and 2, MLP 64; 2*m*k*n per product
    return (2 * j * 16 * 48            # qkv
            + 2 * 2 * j * 16 * j       # QK^T and PV over both heads
            + 2 * j * 16 * 16          # proj
            + 2 * 2 * j * 16 * 16      # MGCN W0, W1
            + 2 * j * j * 16           # MGCN off-diagonal adjacency
            + 2 * j * 16 * 16          # XFeat ring 0
            + 2 * j * 16 * 2           # XFeat ring 1
            + 2 * j * j * 16           # ring 0 masked sum
            + 2 * j * j * 2            # ring 1 masked sum
            + 2 * j * 18 * 16          # linearback
            + 2 * j * 16 * 64 * 2)     # MLP


def hand_lbf_layer(j):
    # Nv=5, C=8, MLP 32
    return (2 * 5 * 8 * 8 + 2 * 2 * j * 8 * 8   # q; k, v
            + 2 * 2 * 5 * 8 * j                 # QK^T, PV
            + 2 * 5 * 8 * 8                     # proj
            + 2 * 2 * 5 * 8 * 32                # MLP
            + 3 * 2 * 5 * 8 * 8                 # self q, k, v
            + 2 * 2 * 5 * 8 * 5                 # self QK^T, PV
            + 2 * 5 * 8 * 8)                    # self out


@pytest.mark.parametrize("j", [17, 19])
def test_forward_counts_by_hand(j):
    d = counts.dims(dict(SMALL, num_joint=j))
    assert counts.gat_block(d) == hand_gat_block(j)
    assert counts.gat_trunk(d) == 2 * hand_gat_block(j)
    assert counts.lbf_layer(d) == hand_lbf_layer(j)
    assert counts.lbf_stack(d) == 2 * hand_lbf_layer(j)
    outside = (2 * j * 2 * 64 + 2 * j * 64 * 16 + 2 * j * 16 * 3 * j)
    assert counts.gat_outside_trunk(d) == outside
    mdr_out = (2 * j * 21 * 8 + 2 * 5 * 6 * 8          # tokens
               + 2 * 5 * 8 * 5 + 2 * 5 * 8 * 3         # motion (K+3), bias
               + 7 * 2 * 2 * 5 + 2 * 5 * 2 * 3         # conv, A @ B
               + 7 * 2 * 7 * 5)                        # upsample
    assert counts.mdr_outside_stack(d) == mdr_out


@pytest.mark.parametrize("j", [17, 19])
def test_training_is_three_forwards(j):
    """Forward, input gradients, weight gradients: no recompute term."""
    d = counts.dims(dict(SMALL, num_joint=j))
    assert counts.train_step(d) == 3 * counts.model_forward(d)
    for name, fwd in (("k5_roofline.train", counts.gat_trunk),
                      ("k4_roofline.train", counts.lbf_stack)):
        ops, _ = spec.metric_reader(name).ops_and_bytes(
            dict(SMALL, num_joint=j), 4)
        assert ops == 3 * fwd(d) * 4


@pytest.mark.parametrize("j", [17, 19])
def test_bytes_by_hand(j):
    d = counts.dims(dict(SMALL, num_joint=j))
    blk = (16 * 48 + 48 + 16 * 16 + 16 + 2 * 16 * 16 + j * 16 + j * j + 16
           + 16 * 16 + 16 + 16 * 2 + 2 + 18 * 16 + 16 + 4 * 16
           + 16 * 64 + 64 + 64 * 16 + 16)
    assert counts.gat_block_params(d) == blk
    assert counts.k1_bytes(d, 3) == 2 * 3 * j * 16 * 2 + 2 * blk * 2 \
        + 2 * j * j * 4
    lay = (3 * 64 + 64 + 8 + 4 * 8 + 8 * 32 + 32 + 32 * 8 + 8 + 2 * 8
           + 4 * (64 + 8))
    assert counts.lbf_layer_params(d) == lay
    assert counts.k2_bytes(d, 3) == (2 * 3 * 5 * 8 + 3 * j * 8) * 2 \
        + 2 * lay * 2


def test_published_widths_match_the_records():
    """At the cells' shapes: K1's and K2's least times at B=2048 and K4's
    and K5's at B=512 are the ops bounds PERF.md has carried (0.116,
    0.616, 0.462 and 0.087 ms), and the J=19 model counts more."""
    cfg = spec.config("gator-h36m17")
    d = counts.dims(cfg)
    k1 = spec.metric_reader("k1_roofline.serve").ops_and_bytes(cfg, 2048)
    k2 = spec.metric_reader("k2_roofline.serve").ops_and_bytes(cfg, 2048)
    assert counts.bound_s(*k1) == pytest.approx((0.116e-3, "ops"),
                                                rel=0.01)
    assert counts.bound_s(*k2)[0] == pytest.approx(0.616e-3, rel=0.01)
    k4 = spec.metric_reader("k4_roofline.train").ops_and_bytes(cfg, 512)
    k5 = spec.metric_reader("k5_roofline.train").ops_and_bytes(cfg, 512)
    assert counts.bound_s(*k4)[0] == pytest.approx(0.462e-3, rel=0.01)
    assert counts.bound_s(*k5)[0] == pytest.approx(0.087e-3, rel=0.02)
    coco = counts.dims(spec.config("gator-coco19"))
    assert counts.model_forward(coco) > counts.model_forward(d)
    assert 3.5e8 < counts.model_forward(d) < 4.5e8
