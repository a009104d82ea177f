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
width 64 (its other instance) as at 128. K2's bf16 rows kernel
(csrc/lbf_rows_wg.cuh) against the rows kernel it replaced
(csrc/lbf_layer.cuh's, which f32 keeps) on the same inputs, over batch,
vertex and joint counts and a batch whose items split unevenly over the
persistent grid; the serving call's row launches through it. K2's bf16
self-attention (csrc/lbf_selfattn_wg.cuh) against the two-pass kernel it
replaced (csrc/lbf_stack.cu's, which f32 and rows past NV_WG keys keep) on
the same rows output, over batch and vertex counts up to NV_WG and one past
it; the serving call's self-attention launches through it.
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
from gator_tpu_torch.nn import cuda_lib
from gator_tpu_torch.nn.lbf_stack import (_SIGNATURE, NV_WG,
                                          rows_launches, selfattn_launches,
                                          stack_plan)
from gator_tpu_torch.serving import make_serving_fn

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
    """The kernels each dtype takes at Nv=431. bf16: the self-attention on
    lbf_selfattn_wg.cuh's kernel (one persistent CTA an SM of four
    warpgroups holding the whole 448-key row, at most 128 registers a
    thread, its two K/V slots, query tiles, L3, head 0's o, the partial
    o tiles and y3 in 190-227 KB of shared memory) and the rows on
    lbf_rows_wg.cuh's (one CTA an SM of three warpgroups on 64-row tiles,
    its weights resident). f32: the two-pass self-attention, two CTAs an
    SM, and lbf_layer.cuh's rows kernel (two CTAs an SM of 16-row
    tiles)."""
    plan = stack_plan(dtype, 431)
    assert plan["rows_registers"] > 0
    if dtype == torch.bfloat16:
        assert plan["selfattn_kernel"] == "lbf_selfattn_wg"
        assert plan["selfattn_ctas_per_sm"] == 1
        assert plan["selfattn_warpgroups"] == 4
        assert plan["chunk_keys"] == NV_WG == 448
        assert 190 * 1024 < plan["selfattn_smem_bytes"] <= 227 * 1024
        assert 0 < plan["selfattn_registers"] <= 65536 // (128 * 4)
        assert plan["rows_kernel"] == "lbf_rows_wg"
        assert plan["rows_ctas_per_sm"] == 1
        assert plan["rows_tile"] == 64 and plan["rows_warpgroups"] == 3
        assert 120 * 1024 < plan["rows_smem_bytes"] <= 227 * 1024
        assert plan["rows_registers"] <= 65536 // (128 * 3)
    else:
        assert plan["chunk_keys"] % 64 == 0 and plan["chunk_keys"] >= 64
        assert plan["selfattn_ctas_per_sm"] >= 2
        assert plan["rows_kernel"] == "lbf_layer"
        assert plan["rows_ctas_per_sm"] >= 2
        assert plan["rows_tile"] == 16 and plan["rows_warpgroups"] == 0


# (B, Nv, J): every batch at every vertex count at J=17, the other joint
# counts at a ragged Nv, and the serving shape at the most joints
ROWS_CASES = ([(b, nv, 17) for b in (1, 7, 2048) for nv in (16, 64, 65, 431)]
              + [(7, 65, j) for j in (1, 19, 32)] + [(2048, 431, 32)])


def _rows(entry: str, x, joints, layer, offsets):
    """One rows launch through the C entry `entry` of csrc/lbf_stack.cu
    ("lbf_rows_launch", the bf16 kernel, or "lbf_rows_shared_launch",
    lbf_layer.cuh's): x f32 [B, Nv, 64], joints and one layer's packed
    weights in bf16 -> (y3 f32, q2, k2, v2 bf16)."""
    b, nv, _ = x.shape
    y3 = torch.empty_like(x)
    q2, k2, v2 = (torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")
                  for _ in range(3))
    fn = getattr(cuda_lib.load("lbf_stack", _SIGNATURE), entry)
    cuda_lib.check(fn(1, x.data_ptr(), joints.data_ptr(), layer.data_ptr(),
                      offsets.data_ptr(), y3.data_ptr(), q2.data_ptr(),
                      k2.data_ptr(), v2.data_ptr(), b, nv, joints.shape[1],
                      cuda_lib.stream_ptr(x)), entry)
    return y3, q2, k2, v2


@pytest.mark.cuda
@pytest.mark.parametrize("b,nv,nj", ROWS_CASES)
def test_lbf_rows_wg_matches_the_shared_rows_kernel(model, b, nv, nj):
    """The bf16 rows launch against lbf_layer.cuh's rows kernel on the
    same inputs and layer. Both round each product's operands to bf16, so
    the products are exact and only the order of the f32 sums differs:
    where no bf16 rounding flips, y3 agrees to f32 rounding (~5e-7). A
    reordered sum can flip the bf16 rounding of an intermediate (a cross
    probability, the cross output, a hidden unit, a LayerNorm output),
    which moves that row's y3 by up to ~3e-3 (measured on the card) and
    its q2/k2/v2 by a bf16 step or a flipped y3 operand's share of a
    product; a flip in a sample's joint K or V moves every row of the
    sample (B=1 at Nv=431 shows one: 59 % of y3 by more than 1e-4, a
    quarter of q2/k2/v2 unequal). Bars: y3 within 1e-2 and 1e-3 on
    average, q2/k2/v2 within the stack's bf16 bar (5e-2), and from B=7 on,
    where a K/V flip is one sample among several, at most 1 % of q2/k2/v2
    unequal (measured 0.06-0.7 %). A wrong row, head or weight block moves
    values by O(1). B=2048 at Nv=431 splits 14,336 tiles unevenly over
    the persistent grid: one CTA an SM of three warpgroups, each taking a
    contiguous run of (sample, 64-row tile) items (asserted)."""
    mdr = model.pose2mesh
    w = fold_stack_weights(mdr, torch.bfloat16, "cuda")
    if (b, nv) == (2048, 431):
        plan = stack_plan(torch.bfloat16, nv)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        items = b * -(-nv // plan["rows_tile"])
        assert items > sms * plan["rows_warpgroups"]
        assert items % (sms * plan["rows_warpgroups"]) != 0
    rng = np.random.default_rng(b * 1000 + nv + nj)
    x = _randn(rng, b, nv, 64)
    joints = _randn(rng, b, nj, 64).to(torch.bfloat16)
    for layer in range(w.flat.shape[0]):
        new = _rows("lbf_rows_launch", x, joints, w.flat[layer], w.offsets)
        old = _rows("lbf_rows_shared_launch", x, joints, w.flat[layer],
                    w.offsets)
        torch.cuda.synchronize()
        dy = (new[0] - old[0]).abs()
        assert dy.max().item() <= 1e-2 and dy.mean().item() <= 1e-3, (
            dy.max().item(), dy.mean().item())
        for got, want in zip(new[1:], old[1:]):
            err = (got.float() - want.float()).abs().max().item()
            assert err <= TOL[torch.bfloat16], err
            if b >= 7:
                assert (got != want).float().mean().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,nv,nj", [(1, 16, 17), (7, 65, 1), (7, 64, 19),
                                     (7, 431, 32), (1, 431, 17)])
def test_lbf_stack_bf16_matches_ref_across_shapes(model, b, nv, nj):
    """The whole bf16 stack (the new rows kernel and the self-attention,
    three layers) against its plain version at other batch, vertex and
    joint counts than the model's: the bf16 bar."""
    rng = np.random.default_rng(b + nv + nj)
    verts = _randn(rng, b, nv, 64).to(torch.bfloat16)
    joints = _randn(rng, b, nj, 64).to(torch.bfloat16)
    weights = fold_stack_weights(model.pose2mesh, torch.bfloat16, "cuda")
    got = lbf_stack(verts, joints, weights, 2)
    torch.cuda.synchronize()
    ref = lbf_stack_ref(verts, joints, weights, 2)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[torch.bfloat16], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_serving_row_launches_take_the_dtypes_rows_kernel(model, dtype):
    """A serving call's three row launches, as the C entry counts them by
    the kernel it launched: all on the dtype's rows kernel."""
    serve = make_serving_fn(model, dtype)
    pose = torch.randn(4, model.pose_lifter.spec.num_joint, 2,
                       device="cuda")
    before = rows_launches()
    serve(pose)
    torch.cuda.synchronize()
    after = rows_launches()
    grown = {k: after[k] - before[k] for k in before}
    want = "lbf_rows_wg" if dtype == torch.bfloat16 else "lbf_layer"
    assert grown == {"lbf_layer": 0, "lbf_rows_wg": 0, want: 3}, grown


# (B, Nv): every batch at every vertex count, then the longest row the bf16
# kernel holds and one key past it, which the two-pass kernel takes
SA_CASES = ([(b, nv) for b in (1, 7, 2048) for nv in (16, 64, 65, 431)]
            + [(7, NV_WG), (7, NV_WG + 1)])


def _selfattn(entry: str, rows, layer, offsets):
    """One self-attention launch through the C entry `entry` of
    csrc/lbf_stack.cu ("lbf_selfattn_launch", routed, or
    "lbf_selfattn_shared_launch", the two-pass kernel) on a rows launch's
    (y3 f32, q2, k2, v2 bf16) and one layer's packed bf16 weights -> x'
    (f32)."""
    y3, q2, k2, v2 = rows
    b, nv, _ = y3.shape
    out = torch.empty_like(y3)
    fn = getattr(cuda_lib.load("lbf_stack", _SIGNATURE), entry)
    cuda_lib.check(fn(1, q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
                      y3.data_ptr(), layer.data_ptr(), offsets.data_ptr(),
                      out.data_ptr(), b, nv, cuda_lib.stream_ptr(y3)), entry)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,nv", SA_CASES)
def test_lbf_selfattn_wg_matches_the_two_pass_kernel(model, b, nv):
    """The routed bf16 self-attention launch against csrc/lbf_stack.cu's
    two-pass kernel (the uncounted C entry) on the same rows output
    (q2/k2/v2/y3 of a bf16 rows launch) and layer, every layer. Up to
    NV_WG keys the launch takes lbf_selfattn_wg.cuh's kernel, past it the
    two-pass one, bit for bit (the counter shows which). Both compute the
    same roundings (the normalised probabilities and PV's output to bf16)
    and differ in the order of f32 sums only (the exponential sum, PV,
    L3), so most of x' is bit-equal (the median difference is 0 on the
    card); a flipped p or o moves a row of x' by an o step's share of L3
    (measured up to 7e-4). Bars: x' within the stack's bf16 bar (5e-2),
    and from B=7 on at most 2 % of x' moved by more than 1e-5 (measured
    0.02-0.64 %; B=1 reads up to 0.95 %, one sample's flips). A wrong key,
    head, row or weight block moves x' by O(0.1)."""
    w = fold_stack_weights(model.pose2mesh, torch.bfloat16, "cuda")
    rng = np.random.default_rng(b * 1000 + nv + 7)
    x = _randn(rng, b, nv, 64)
    joints = _randn(rng, b, 17, 64).to(torch.bfloat16)
    want = "lbf_selfattn_wg" if nv <= NV_WG else "two_pass"
    for layer in range(w.flat.shape[0]):
        rows = _rows("lbf_rows_launch", x, joints, w.flat[layer], w.offsets)
        before = selfattn_launches()
        new = _selfattn("lbf_selfattn_launch", rows, w.flat[layer],
                        w.offsets)
        after = selfattn_launches()
        old = _selfattn("lbf_selfattn_shared_launch", rows, w.flat[layer],
                        w.offsets)
        torch.cuda.synchronize()
        grown = {k: after[k] - before[k] for k in before}
        assert grown == {"two_pass": 0, "lbf_selfattn_wg": 0, want: 1}, grown
        if nv > NV_WG:
            assert torch.equal(new, old)
            continue
        dx = (new - old).abs()
        assert dx.max().item() <= TOL[torch.bfloat16], dx.max().item()
        if b >= 7:
            moved = (dx > 1e-5).float().mean().item()
            assert moved <= 2e-2, moved
        x = new


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_serving_selfattn_launches_take_the_dtypes_kernel(model, dtype):
    """A serving call's three self-attention launches, as the C entry
    counts them by the kernel it launched: bf16 on lbf_selfattn_wg.cuh's
    (the model's vertex tokens are within NV_WG), f32 on the two-pass
    kernel."""
    assert model.pose2mesh.spec.coarse_num <= NV_WG
    serve = make_serving_fn(model, dtype)
    pose = torch.randn(4, model.pose_lifter.spec.num_joint, 2,
                       device="cuda")
    before = selfattn_launches()
    serve(pose)
    torch.cuda.synchronize()
    after = selfattn_launches()
    grown = {k: after[k] - before[k] for k in before}
    want = "lbf_selfattn_wg" if dtype == torch.bfloat16 else "two_pass"
    assert grown == {"two_pass": 0, "lbf_selfattn_wg": 0, want: 3}, grown
