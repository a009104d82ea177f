"""The layer kernels K2-layer (`lbf_layer`, csrc/lbf_layer.cu) and T1
(`run_layers`, csrc/lbf_ablate.cu) against their plain PyTorch versions,
on a card. Skips without one.

This file imports no JAX, so it runs on a machine with only PyTorch:
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_layer_kernels_cuda.py
Bars as in test_torch_kernels_cuda.py: f32 atol 1e-4; bf16 atol 5e-2 (sums
taken in another order can flip a bf16 rounding of an intermediate).
Past 65535 samples (the grid's y limit) the host launches the kernels
again for the rest of the batch: B=65537 at Nv=50 checks that seam. The
self-attention kernel of each variant (K2-layer's; T1's full, preproj,
fold1dot, bf16smax, nosoftmax) gives the same bits on a second run, and
in bf16 those with 64-wide V rows hold two CTAs per SM.
"""
import importlib

import numpy as np
import pytest
import torch

from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.models import GatorSpec, build_gator
from gator_tpu_torch.nn import (MODES, cuda_lib, extract_layer_params,
                                lbf_layer, lbf_layer_ref, run_layers,
                                run_layers_ref)
from gator_tpu_torch.nn.lbf_ablate import ATTN_KERNELS

# the modules (the package exports functions of the same names)
k2_layer = importlib.import_module("gator_tpu_torch.nn.lbf_layer")
t1 = importlib.import_module("gator_tpu_torch.nn.lbf_ablate")

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture(scope="module", params=["human36", "coco"])
def mdr(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assets = build_assets(request.param, data_dirs=[],
                          synthetic_vertex_num=890, seed=0)
    return build_gator(GatorSpec.from_assets(assets, depth=1), seed=5,
                       device="cuda").pose2mesh


def _randn(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()


def _err(got, ref):
    torch.cuda.synchronize()
    return (got.float() - ref.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,nv", [(16, 431), (1100, 431), (3, 50)])
def test_lbf_layer_kernel_matches_ref(mdr, dtype, batch, nv):
    j = mdr.spec.num_joint
    rng = np.random.default_rng(batch + nv)
    verts = _randn(rng, batch, nv, 64).to(dtype)
    joints = _randn(rng, batch, j, 64).to(dtype)
    weights = extract_layer_params(mdr, 1, dtype, "cuda")
    before = lbf_layer.launches
    got = lbf_layer(verts, joints, weights, 2)
    assert lbf_layer.launches == before + 2
    assert got.dtype == dtype and got.shape == verts.shape
    err = _err(got, lbf_layer_ref(verts, joints, weights, 2))
    assert err <= TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_run_layers_kernel_matches_ref(mdr, dtype, mode):
    j = mdr.spec.num_joint
    rng = np.random.default_rng(MODES.index(mode))
    verts = _randn(rng, 16, 431, 64).to(dtype)
    joints = _randn(rng, 16, j, 64).to(dtype)
    layers = [extract_layer_params(mdr, i, dtype, "cuda") for i in range(3)]
    before = run_layers.launches
    got = run_layers(verts, joints, layers, 2, 8, mode)
    per_layer = 1 if mode in ("lnonly", "mlponly", "noself") else 2
    assert run_layers.launches == before + 3 * per_layer
    err = _err(got, run_layers_ref(verts, joints, layers, 2, 8, mode))
    assert err <= TOL[dtype], (mode, err)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "fold1dot", "nosoftmax"])
def test_run_layers_kernel_does_not_depend_on_group(mdr, mode):
    rng = np.random.default_rng(7)
    verts = _randn(rng, 1100, 431, 64)
    joints = _randn(rng, 1100, mdr.spec.num_joint, 64)
    layers = [extract_layer_params(mdr, 0, torch.float32, "cuda")]
    outs = [run_layers(verts, joints, layers, 2, g, mode) for g in (1, 4)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    err = _err(outs[0], run_layers_ref(verts, joints, layers, 2, 1, mode))
    assert err <= TOL[torch.float32], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ("lbf_layer",) + ATTN_KERNELS)
def test_attention_variants_repeat_bit_identical(mdr, dtype, variant):
    """Each self-attention kernel (K2-layer's, and T1's five) gives the same
    bits on a second run: the heads' sums meet in a fixed order."""
    rng = np.random.default_rng(3)
    verts = _randn(rng, 16, 431, 64).to(dtype)
    joints = _randn(rng, 16, mdr.spec.num_joint, 64).to(dtype)
    w = extract_layer_params(mdr, 0, dtype, "cuda")
    if variant == "lbf_layer":
        outs = [lbf_layer(verts, joints, w, 2) for _ in range(2)]
    else:
        outs = [run_layers(verts, joints, [w], 2, 1, variant)
                for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_bf16_64_wide_attention_fits_two_ctas_per_sm(mdr):
    """The bf16 self-attention kernels whose V rows are 64 wide (all but
    fold1dot's 128) hold two CTAs per SM at Nv=431 and at a ragged 50."""
    for nv in (431, 50):
        infos = {"lbf_layer": k2_layer.attn_info(torch.bfloat16, nv)}
        infos.update({m: t1.attn_info(torch.bfloat16, m, nv)
                      for m in ATTN_KERNELS if m != "fold1dot"})
        for name, info in infos.items():
            assert info["ctas_per_sm"] >= 2, (name, nv, info)
            assert info["chunk_keys"] % 64 == 0, (name, nv, info)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lbf_layer", "run_layers"])
def test_kernels_launch_again_past_the_grid(mdr, kernel):
    j = mdr.spec.num_joint
    rng = np.random.default_rng(11)
    verts = _randn(rng, 65537, 50, 64)
    joints = _randn(rng, 65537, j, 64)
    w = extract_layer_params(mdr, 0, torch.float32, "cuda")
    if kernel == "lbf_layer":
        got, ref = (fn(verts, joints, w, 2) for fn in (lbf_layer,
                                                       lbf_layer_ref))
    else:
        got, ref = (fn(verts, joints, [w], 2, 1, "full")
                    for fn in (run_layers, run_layers_ref))
    err = _err(got, ref)
    assert err <= TOL[torch.float32], err
    assert _err(got[-1], ref[-1]) <= TOL[torch.float32]


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(mdr):
    j = mdr.spec.num_joint
    f32, bf16 = torch.float32, torch.bfloat16
    w = extract_layer_params(mdr, 0, f32, "cuda")
    verts = torch.zeros(2, 431, 64, device="cuda")
    joints = torch.zeros(2, j, 64, device="cuda")
    with pytest.raises(TypeError):
        lbf_layer(verts.to(bf16), joints.to(bf16), w, 2)
    with pytest.raises(ValueError):
        lbf_layer(verts, joints, w, 4)
    with pytest.raises(ValueError):
        lbf_layer(verts, torch.zeros(2, 33, 64, device="cuda"), w, 2)
    with pytest.raises(ValueError):
        lbf_layer(torch.zeros(2, 431, 32, device="cuda"),
                  torch.zeros(2, j, 32, device="cuda"), w, 2)
    stack = [extract_layer_params(mdr, i, f32, "cuda") for i in range(2)]
    with pytest.raises(ValueError):
        lbf_layer(verts, joints, cuda_lib.stack(stack), 2)
    with pytest.raises(ValueError):
        lbf_layer(verts, joints, extract_layer_params(mdr, 0, f32, "cpu"), 2)
    with pytest.raises(ValueError):
        run_layers(verts, joints, [w], 2, 2, "noattention")
    with pytest.raises(ValueError):
        run_layers(verts, joints, [w], 2, 3, "full")
    with pytest.raises(TypeError):
        run_layers(verts.to(torch.float16), joints.to(torch.float16),
                   [extract_layer_params(mdr, 0, torch.float16, "cuda")], 2,
                   2, "full")
