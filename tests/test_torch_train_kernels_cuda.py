"""The training kernels (K5 gat_trunk_train, K4 lbf_stack_train) against
their plain versions, on a card, with the masks the kernels export. Skips
without one.

This file imports no JAX, so it runs on a machine with only PyTorch:
    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_train_kernels_cuda.py
Every exported mask must equal the plain hash's bit for bit. Bars on the
output, the input gradients and every parameter gradient, each scaled by
its max: f32 1e-4; bf16 5e-2 (sums taken in another order can flip a bf16
rounding of an intermediate). Attention key biases have a zero true
gradient and are left out of the scaled comparison. K5 at embed width 64
(its other instance) as at 128.
"""
import numpy as np
import pytest
import torch

from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.models import GatorSpec, build_gator
from gator_tpu_torch.nn.gat_trunk_train import (BlockCfg, block_masks,
                                                extract_block_params,
                                                gat_block_train_ref,
                                                gat_trunk_train,
                                                gat_trunk_train_ref,
                                                kernel_info)
from gator_tpu_torch.nn.lbf_stack_train import (DEFAULT_RATES, ZERO_RATES,
                                                extract_layer_params,
                                                lbf_stack_train,
                                                lbf_stack_train_ref)
from gator_tpu_torch.nn.lbf_stack_train import kernel_info as k4_info

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
K5_RATES = {"default": dict(attn_rate=0.4, proj_rate=0.4, mlp_rate=0.1,
                            drop_path_rate=0.2),
            "zero": dict(attn_rate=0.0, proj_rate=0.0, mlp_rate=0.0,
                         drop_path_rate=0.0)}
K4_RATES = {"default": DEFAULT_RATES, "zero": ZERO_RATES}


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


def _grads(module, prefix=""):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()
            if p.grad is not None and n.startswith(prefix)}


def _scaled(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-6)).item()


def _check_masks(got, want):
    for k_unit, p_unit in zip(got, want):
        for name, m in k_unit.items():
            ref = p_unit[name]
            if ref is None:
                assert bool((m == 1).all()), name
            else:
                assert torch.equal(m, ref), name


def _check_grads(got, want, tol):
    assert set(got) == set(want) and got
    for name, w in want.items():
        g = got[name]
        if name.endswith("attn.qkv.bias"):
            c = g.shape[0] // 3
            keep = torch.ones_like(g, dtype=torch.bool)
            keep[c:2 * c] = False
            g, w = g[keep], w[keep]
        elif "selfatt" in name and name.endswith("linears.1.bias"):
            continue
        assert _scaled(g, w) <= tol, name


def _run_k5(gat, x0, cot, rates, fn):
    x = x0.clone().requires_grad_(True)
    bias = gat.get_hop_path_encoding().detach().float().requires_grad_(True)
    gat.zero_grad(set_to_none=True)
    export = []
    out = fn(x, bias, [extract_block_params(b) for b in gat.blocks],
             gat.spec.masks_xfeat, 8, 77, export=export, **rates)
    out.backward(cot)
    torch.cuda.synchronize()
    return out.detach(), x.grad, bias.grad, _grads(gat.blocks), export


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rates", sorted(K5_RATES))
# 800 samples: 800 one-sample tiles, three waves of two CTAs per SM, and
# 13,600 rows in gat_block_wgrad's eight chunks
@pytest.mark.parametrize("batch", [1, 5, 800])
def test_gat_trunk_train_kernels_match_plain(model, dtype, rates, batch):
    gat = model.pose_lifter
    j = gat.spec.num_joint
    rng = np.random.default_rng(batch)
    x0 = _randn(rng, batch, j, 128).to(dtype)
    cot = _randn(rng, batch, j, 128).to(dtype)
    before = (gat_trunk_train.launches_fwd, gat_trunk_train.launches_bwd)
    got = _run_k5(gat, x0, cot, K5_RATES[rates], gat_trunk_train)
    # per block: one forward launch; four backward (gat_block_bwd,
    # gat_block_wgrad, the two reductions)
    assert (gat_trunk_train.launches_fwd, gat_trunk_train.launches_bwd) == (
        before[0] + 2, before[1] + 8)
    want = _run_k5(gat, x0, cot, K5_RATES[rates], gat_trunk_train_ref)
    _check_masks(got[4], want[4])
    for a, b in zip(got[:3], want[:3]):
        assert _scaled(a, b) <= TOL[dtype]
    _check_grads(got[3], want[3], TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rates", sorted(K5_RATES))
@pytest.mark.parametrize("batch", [1, 5, 512])
def test_gat_trunk_train_kernels_match_plain_at_embed_64(model64, dtype,
                                                         rates, batch):
    """K5's C = 64 instance: head width 8, the 8-wide XFeat ring's
    products of depth 8 (bf16: half an mma step, zero-padded)."""
    gat = model64.pose_lifter
    j = gat.spec.num_joint
    rng = np.random.default_rng(batch + 64)
    x0 = _randn(rng, batch, j, 64).to(dtype)
    cot = _randn(rng, batch, j, 64).to(dtype)
    got = _run_k5(gat, x0, cot, K5_RATES[rates], gat_trunk_train)
    want = _run_k5(gat, x0, cot, K5_RATES[rates], gat_trunk_train_ref)
    _check_masks(got[4], want[4])
    for a, b in zip(got[:3], want[:3]):
        assert _scaled(a, b) <= TOL[dtype]
    _check_grads(got[3], want[3], TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gat_trunk_train_repeat_runs_bit_identical(model, dtype):
    """At the main path's batch (512 tiles, gat_block_wgrad's eight
    chunks): two runs with one seed agree bit for bit (output, dx, dbias,
    every parameter gradient, every exported mask); another seed
    differs."""
    gat = model.pose_lifter
    j = gat.spec.num_joint
    rng = np.random.default_rng(512)
    x0 = _randn(rng, 512, j, 128).to(dtype)
    cot = _randn(rng, 512, j, 128).to(dtype)
    runs = [_run_k5(gat, x0, cot, K5_RATES["default"], gat_trunk_train)
            for _ in range(2)]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    assert set(runs[0][3]) == set(runs[1][3])
    for name in runs[0][3]:
        assert torch.equal(runs[0][3][name], runs[1][3][name]), name
    _check_masks(runs[0][4], runs[1][4])
    other = gat_trunk_train(x0, gat.get_hop_path_encoding().detach().float(),
                            [extract_block_params(b) for b in gat.blocks],
                            gat.spec.masks_xfeat, 8, 78)
    assert not torch.equal(other.detach(), runs[0][0])


@pytest.mark.cuda
def test_gat_block_train_takes_65537_samples(model):
    """One block at B=65537 (65,537 tiles, a 1-D grid past 65,535): the
    first and last 16 samples' output and dx equal the plain version run
    on those samples with the masks the kernel exported for them (f32,
    1e-4); the first 16 samples' masks equal the hash's."""
    gat = model.pose_lifter
    j = gat.spec.num_joint
    b = 65537
    rng = np.random.default_rng(65537)
    x0 = _randn(rng, b, j, 128)
    cot = _randn(rng, b, j, 128)
    bias = gat.get_hop_path_encoding().detach().float()
    bp = {k: t.detach()
          for k, t in extract_block_params(gat.blocks[0]).items()}
    x = x0.clone().requires_grad_(True)
    export = []
    out = gat_trunk_train(x, bias, [bp], gat.spec.masks_xfeat, 8, 91,
                          export=export, **K5_RATES["default"])
    out.backward(cot)
    torch.cuda.synchronize()
    got = export[0]
    cfg = BlockCfg(num_heads=8, block=0, seed=91, attn_rate=0.4,
                   proj_rate=0.4, mlp_rate=0.1, path_rate=0.0)
    _check_masks([{k: m[:16] for k, m in got.items()}],
                 [block_masks(cfg, 16, j, 128, x0.device)])
    xm = torch.as_tensor(gat.spec.masks_xfeat, dtype=torch.float32,
                         device="cuda")
    for part in (slice(0, 16), slice(b - 16, b)):
        xs = x0[part].clone().requires_grad_(True)
        mk = {k: m[part] for k, m in got.items()}
        want = gat_block_train_ref(xs, bias, bp, xm, mk, 8)
        want.backward(cot[part])
        assert _scaled(out[part].detach(), want.detach()) <= TOL[
            torch.float32]
        assert _scaled(x.grad[part], xs.grad) <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 64])
def test_gat_trunk_train_kernels_fit_two_ctas_per_sm_in_bf16(model, c):
    info = kernel_info(torch.bfloat16, c)
    assert info["gat_block_fwd"]["ctas_per_sm"] >= 2, info
    assert info["gat_block_bwd"]["ctas_per_sm"] >= 2, info


def _run_k4(mdr, x0, j0, cot, rates, fn):
    x = x0.clone().requires_grad_(True)
    jt = j0.clone().requires_grad_(True)
    mdr.zero_grad(set_to_none=True)
    export = []
    out = fn(x, jt, [extract_layer_params(mdr, i) for i in range(3)], 2, 55,
             rates=rates, export=export)
    out.backward(cot)
    torch.cuda.synchronize()
    grads = _grads(mdr, ("encoder", "norm", "selfatt"))
    return out.detach(), x.grad, jt.grad, grads, export


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rates", sorted(K4_RATES))
# (64, 431): 1728 row tiles of 16 on the 264-CTA grid; (300, 50): 1200
# row tiles, and 300 samples on the joints kernel's 264 CTAs, so CTAs loop
# (and walk into the next sample); 433 = 27 * 16 + 1 and 17 leave one row
# and one ragged row in the last tile
@pytest.mark.parametrize("batch,nv", [(1, 431), (3, 50), (64, 431),
                                      (300, 50), (5, 433), (2, 17)])
def test_lbf_stack_train_kernels_match_plain(model, dtype, rates, batch, nv):
    mdr = model.pose2mesh
    j = mdr.spec.num_joint
    rng = np.random.default_rng(nv + batch)
    x0 = _randn(rng, batch, nv, 64).to(dtype)
    j0 = _randn(rng, batch, j, 64).to(dtype)
    cot = _randn(rng, batch, nv, 64).to(dtype)
    before = (lbf_stack_train.launches_fwd, lbf_stack_train.launches_bwd)
    got = _run_k4(mdr, x0, j0, cot, K4_RATES[rates], lbf_stack_train)
    # per layer two forward launches and six backward ones (dq, dk/dv, rows,
    # joints, weight gradients, the reduction)
    assert (lbf_stack_train.launches_fwd, lbf_stack_train.launches_bwd) == (
        before[0] + 6, before[1] + 18)
    want = _run_k4(mdr, x0, j0, cot, K4_RATES[rates], lbf_stack_train_ref)
    _check_masks(got[4], want[4])
    for a, b in zip(got[:3], want[:3]):
        assert _scaled(a, b) <= TOL[dtype]
    _check_grads(got[3], want[3], TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lbf_stack_train_repeat_runs_bit_identical(model, dtype):
    """At a tiling where CTAs walk many tiles across samples (64 x 433):
    two runs with one seed agree bit for bit (output, dx, djoints, every
    parameter gradient and every exported mask); another seed differs."""
    mdr = model.pose2mesh
    j = mdr.spec.num_joint
    rng = np.random.default_rng(433)
    x0 = _randn(rng, 64, 433, 64).to(dtype)
    j0 = _randn(rng, 64, j, 64).to(dtype)
    cot = _randn(rng, 64, 433, 64).to(dtype)
    runs = [_run_k4(mdr, x0, j0, cot, DEFAULT_RATES, lbf_stack_train)
            for _ in range(2)]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    assert set(runs[0][3]) == set(runs[1][3])
    for name in runs[0][3]:
        assert torch.equal(runs[0][3][name], runs[1][3][name]), name
    _check_masks(runs[0][4], runs[1][4])
    x = x0.clone().requires_grad_(True)
    other = lbf_stack_train(x, j0, [extract_layer_params(mdr, i)
                                    for i in range(3)], 2, 56)
    assert not torch.equal(other.detach(), runs[0][0])


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [17, 431, 433])
def test_lbf_stack_train_self_attention_fits_two_ctas_per_sm_in_bf16(model,
                                                                     nv):
    info = k4_info(torch.bfloat16, nv)
    for name in ("lbf_sa_fwd", "lbf_sa_bwd_dq", "lbf_sa_bwd_dkv"):
        assert info[name]["ctas_per_sm"] >= 2, info
    assert info["lbf_joints_bwd"]["ctas_per_sm"] >= 1, info


@pytest.mark.cuda
def test_train_wrappers_reject_what_the_kernels_do_not_take(model):
    gat = model.pose_lifter
    j = gat.spec.num_joint
    x = torch.zeros(2, j, 64, device="cuda")
    bias = torch.zeros(8, j, j, device="cuda")
    with pytest.raises(ValueError):
        gat_trunk_train(x, bias, [extract_block_params(b)
                                  for b in gat.blocks],
                        gat.spec.masks_xfeat, 8, 0)
    mdr = model.pose2mesh
    with pytest.raises(TypeError):
        lbf_stack_train(torch.zeros(2, 50, 64, device="cuda"),
                        torch.zeros(2, j, 64, device="cuda",
                                    dtype=torch.bfloat16),
                        [extract_layer_params(mdr, i) for i in range(3)],
                        2, 0)
