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
gradient and are left out of the scaled comparison.
"""
import numpy as np
import pytest
import torch

from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.models import GatorSpec, build_gator
from gator_tpu_torch.nn.gat_trunk_train import (extract_block_params,
                                                gat_trunk_train,
                                                gat_trunk_train_ref)
from gator_tpu_torch.nn.lbf_stack_train import (DEFAULT_RATES, ZERO_RATES,
                                                extract_layer_params,
                                                lbf_stack_train,
                                                lbf_stack_train_ref)

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
# 800 samples: 267 groups of 3 on the 264-CTA grid, so CTAs loop
@pytest.mark.parametrize("batch", [1, 5, 800])
def test_gat_trunk_train_kernels_match_plain(model, dtype, rates, batch):
    gat = model.pose_lifter
    j = gat.spec.num_joint
    rng = np.random.default_rng(batch)
    x0 = _randn(rng, batch, j, 128).to(dtype)
    cot = _randn(rng, batch, j, 128).to(dtype)
    before = (gat_trunk_train.launches_fwd, gat_trunk_train.launches_bwd)
    got = _run_k5(gat, x0, cot, K5_RATES[rates], gat_trunk_train)
    assert (gat_trunk_train.launches_fwd, gat_trunk_train.launches_bwd) == (
        before[0] + 2, before[1] + 4)
    want = _run_k5(gat, x0, cot, K5_RATES[rates], gat_trunk_train_ref)
    _check_masks(got[4], want[4])
    for a, b in zip(got[:3], want[:3]):
        assert _scaled(a, b) <= TOL[dtype]
    _check_grads(got[3], want[3], TOL[dtype])


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
# (64, 431): 896 row tiles on the 264-CTA grid; (300, 50): 600 row tiles,
# and 300 samples on the joints kernel's 264 CTAs, so CTAs loop
@pytest.mark.parametrize("batch,nv", [(1, 431), (3, 50), (64, 431),
                                      (300, 50)])
def test_lbf_stack_train_kernels_match_plain(model, dtype, rates, batch, nv):
    mdr = model.pose2mesh
    j = mdr.spec.num_joint
    rng = np.random.default_rng(nv + batch)
    x0 = _randn(rng, batch, nv, 64).to(dtype)
    j0 = _randn(rng, batch, j, 64).to(dtype)
    cot = _randn(rng, batch, nv, 64).to(dtype)
    before = (lbf_stack_train.launches_fwd, lbf_stack_train.launches_bwd)
    got = _run_k4(mdr, x0, j0, cot, K4_RATES[rates], lbf_stack_train)
    assert (lbf_stack_train.launches_fwd, lbf_stack_train.launches_bwd) == (
        before[0] + 6, before[1] + 18)
    want = _run_k4(mdr, x0, j0, cot, K4_RATES[rates], lbf_stack_train_ref)
    _check_masks(got[4], want[4])
    for a, b in zip(got[:3], want[:3]):
        assert _scaled(a, b) <= TOL[dtype]
    _check_grads(got[3], want[3], TOL[dtype])


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
