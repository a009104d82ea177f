"""The hand-written CUDA kernels (K1 gat_trunk, K2 lbf_stack) against their
plain PyTorch versions, on a card. Skips without one.

This file imports no JAX, so it runs on a machine with only PyTorch:
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py
Bars: f32 atol 1e-4; bf16 atol 5e-2 (sums taken in another order can flip
a bf16 rounding of an intermediate). K1 at its tile edges (B=1, a ragged
last tile, several tiles, the serving batch B=2048) and its geometry as
the card reports it; K2 also at the serving batch B=2048, past the grid's
65535 samples, its launch count and its plan (CTAs per SM). K1 at embed
width 64 (its other instance) as at 128.
"""
import numpy as np
import pytest
import torch

from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.models import GatorSpec, build_gator
from gator_tpu_torch.nn import (fold_stack_weights, fold_trunk_weights,
                                gat_trunk, gat_trunk_ref, lbf_stack,
                                lbf_stack_ref)
from gator_tpu_torch.nn.gat_trunk import (TILE_ROWS, kernel_info,
                                          launch_plan, panel_depth,
                                          panel_order, smem_bytes)
from gator_tpu_torch.nn.lbf_stack import stack_plan

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture(scope="module", params=["human36", "coco"])
def model(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assets = build_assets(request.param, data_dirs=[],
                          synthetic_vertex_num=890, seed=0)
    return build_gator(GatorSpec.from_assets(assets, depth=2), seed=3,
                       device="cuda")


@pytest.fixture(scope="module")
def model64():
    """The human36 model at embed width 64 (8 heads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                          seed=0)
    return build_gator(GatorSpec.from_assets(assets, embed_dim=64, depth=2),
                       seed=4, device="cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 7, 300, 1001, 2048])
def test_gat_trunk_kernel_matches_ref(model, dtype, batch):
    """B=1; 7 and 300, several tiles; 1001, whose last tile is ragged
    (asserted); the serving batch 2048."""
    gat = model.pose_lifter
    j = gat.spec.num_joint
    plan = launch_plan(batch, j, dtype, torch.cuda.get_device_properties(
        0).multi_processor_count)
    if batch == 1001:
        assert batch % plan["g"] != 0, plan
    rng = np.random.default_rng(batch)
    x = _randn(rng, batch, j, 128).to(dtype)
    bias = _randn(rng, 8, j, j)
    masks = gat.blocks[0].x_feat.masks
    weights = fold_trunk_weights(gat.blocks, dtype, "cuda")
    before = gat_trunk.launches
    got = gat_trunk(x, bias, masks, weights, 8)
    torch.cuda.synchronize()
    assert gat_trunk.launches == before + 1
    ref = gat_trunk_ref(x, bias, masks, weights, 8)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 300, 1001, 2048])
def test_gat_trunk_kernel_matches_ref_at_embed_64(model64, dtype, batch):
    """K1's C = 64 instance: head width 8, the XFeat concat 72 taken
    zero-padded to 80."""
    gat = model64.pose_lifter
    j = gat.spec.num_joint
    rng = np.random.default_rng(batch + 64)
    x = _randn(rng, batch, j, 64).to(dtype)
    bias = _randn(rng, 8, j, j)
    masks = gat.blocks[0].x_feat.masks
    weights = fold_trunk_weights(gat.blocks, dtype, "cuda")
    before = gat_trunk.launches
    got = gat_trunk(x, bias, masks, weights, 8)
    torch.cuda.synchronize()
    assert gat_trunk.launches == before + 1
    ref = gat_trunk_ref(x, bias, masks, weights, 8)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,nv", [(1, 431), (3, 431), (2, 50)])
def test_lbf_stack_kernel_matches_ref(model, dtype, batch, nv):
    mdr = model.pose2mesh
    j = mdr.spec.num_joint
    rng = np.random.default_rng(nv + batch)
    verts = _randn(rng, batch, nv, 64).to(dtype)
    joints = _randn(rng, batch, j, 64).to(dtype)
    weights = fold_stack_weights(mdr, dtype, "cuda")
    before = lbf_stack.launches
    got = lbf_stack(verts, joints, weights, 2)
    torch.cuda.synchronize()
    assert lbf_stack.launches == before + 6
    ref = lbf_stack_ref(verts, joints, weights, 2)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(model):
    gat = model.pose_lifter
    j = gat.spec.num_joint
    weights = fold_trunk_weights(gat.blocks, torch.float32, "cuda")
    x = torch.zeros(2, j, 128, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError):
        gat_trunk(x, torch.zeros(8, j, j, device="cuda"),
                  gat.blocks[0].x_feat.masks, weights, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gat_trunk_kernel_geometry_matches_the_wrapper(model, dtype, c):
    """The kernel's tile rows and shared memory are the wrapper's at both
    embed widths, and one CTA of it fits an SM."""
    info = kernel_info(dtype, c)
    assert info["rows"] == TILE_ROWS[dtype]
    assert info["smem_bytes"] == smem_bytes(dtype, c)
    assert info["ctas_per_sm"] >= 1 and info["registers"] > 0
    assert info["threads"] == 4 * TILE_ROWS[dtype] + 32
    assert info["panel_depth"] == panel_depth(dtype)
    assert info["panels"] == len(panel_order(panel_depth(dtype), c))


def _lbf_case(model, dtype, batch, nv, seed):
    mdr = model.pose2mesh
    rng = np.random.default_rng(seed)
    verts = _randn(rng, batch, nv, 64).to(dtype)
    joints = _randn(rng, batch, mdr.spec.num_joint, 64).to(dtype)
    return verts, joints, fold_stack_weights(mdr, dtype, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lbf_stack_kernel_matches_ref_at_the_serving_batch(model, dtype):
    verts, joints, weights = _lbf_case(model, dtype, 2048, 431, 5)
    got = lbf_stack(verts, joints, weights, 2)
    torch.cuda.synchronize()
    ref = lbf_stack_ref(verts, joints, weights, 2)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_lbf_stack_kernel_launches_again_past_the_grid(model):
    """65537 samples: more than the self-attention grid's 65535; the rows
    launch's grid is 1-D."""
    verts, joints, weights = _lbf_case(model, torch.float32, 65537, 50, 6)
    got = lbf_stack(verts, joints, weights, 2)
    torch.cuda.synchronize()
    ref = lbf_stack_ref(verts, joints, weights, 2)
    err = (got - ref).abs().max().item()
    assert err <= TOL[torch.float32], err
    assert (got[-1] - ref[-1]).abs().max().item() <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 65537])
def test_lbf_stack_launches_two_kernels_a_layer(model, batch):
    verts, joints, weights = _lbf_case(model, torch.bfloat16, batch, 50, 7)
    before = lbf_stack.launches
    lbf_stack(verts, joints, weights, 2)
    torch.cuda.synchronize()
    assert lbf_stack.launches == before + 2 * weights.flat.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lbf_stack_plan_keeps_two_self_attention_ctas_per_sm(model, dtype):
    plan = stack_plan(dtype, 431)
    assert plan["chunk_keys"] % 64 == 0 and plan["chunk_keys"] >= 64
    assert plan["selfattn_ctas_per_sm"] >= 2
    assert plan["rows_ctas_per_sm"] >= (3 if dtype == torch.bfloat16 else 2)
