"""K3 (`fused_attention`, csrc/fused_attention.cu) against its plain PyTorch
version on a card. Skips without one.

This file imports no JAX, so it runs on a machine with only PyTorch:
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_eval_kernels_cuda.py
Shapes: the eval path's MDR self-attention (Nq = Nk = 431, 2 heads of 32)
at B = 1, a ragged B = 5 and the eval batch B = 512; a Nq != Nk shape; the
GAT attention shape (17 x 17, 8 heads of 16). Bars: f32 atol 1e-4; bf16
atol 5e-2 (sums in another order can flip a bf16 rounding of a
probability); the autograd Function's gradients scaled by their max within
1e-4; repeat runs bit-identical.
"""
import numpy as np
import pytest
import torch

from gator_tpu_torch.nn import attend
from gator_tpu_torch.nn.fused_attention import (fused_attention,
                                                fused_attention_ref)

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SHAPES = {"B1": (1, 431, 431, 2, 32), "ragged": (5, 431, 431, 2, 32),
          "eval": (512, 431, 431, 2, 32), "nq_ne_nk": (3, 300, 431, 2, 32),
          "gat": (7, 17, 17, 8, 16)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, shape, dtype, with_bias, seed):
    b, nq, nk, h, d = shape
    rng = np.random.default_rng(seed)

    def t(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
            card)

    q, k, v = t(b, nq, h, d), t(b, nk, h, d), t(b, nk, h, d)
    bias = t(h, nq, nk) if with_bias else None
    return q.to(dtype), k.to(dtype), v.to(dtype), bias


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fused_attention_kernel_matches_ref(card, shape, dtype, with_bias):
    q, k, v, bias = _inputs(card, SHAPES[shape], dtype, with_bias, 1)
    scale = q.shape[-1] ** -0.5
    before = fused_attention.launches
    with torch.no_grad():
        got = fused_attention(q, k, v, bias, scale)
        again = fused_attention(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)            # repeat runs bit-identical
    ref = fused_attention_ref(q, k, v, bias, scale)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_fused_attention_strided_views(card):
    """q, k, v as views of one [B, N, 3, H, D] tensor (the layout of a fused
    qkv projection): read in place, same result as contiguous copies."""
    qkv = torch.randn(4, 431, 3, 2, 32, device=card)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with torch.no_grad():
        got = fused_attention(q, k, v, None, 0.2)
        want = fused_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), None, 0.2)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_attention_function_grads(card, with_bias):
    q, k, v, bias = _inputs(card, (3, 431, 431, 2, 32), torch.float32,
                            with_bias, 2)
    cot = torch.randn_like(q)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b1 = b2 = None
    if with_bias:
        b1 = bias.clone().requires_grad_(True)
        b2 = bias.clone().requires_grad_(True)
    fused_attention(*leaves, b1, 0.2).backward(cot)
    fused_attention_ref(*ref_leaves, b2, 0.2).backward(cot)
    pairs = list(zip(leaves, ref_leaves)) + ([(b1, b2)] if with_bias else [])
    for got, want in pairs:
        scale = want.grad.abs().max().item()
        err = (got.grad - want.grad).abs().max().item() / scale
        assert err <= 1e-4, err


@pytest.mark.cuda
def test_attend_routes_large_tiles_to_the_kernel(card):
    x = torch.randn(2, 431, 2, 32, device=card)
    small = torch.randn(2, 17, 8, 16, device=card)
    before = fused_attention.launches
    with torch.no_grad():
        attend(x, x, x, None, 0.2)
        attend(x, x, x, None, 0.2, use_kernel=False)
        attend(small, small, small, None, 0.25)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    x = torch.randn(2, 431, 2, 32, device=card)
    with pytest.raises(TypeError):
        fused_attention(x, x.bfloat16(), x, None, 1.0)
    with pytest.raises(ValueError):
        y = torch.randn(2, 431, 2, 24, device=card)
        fused_attention(y, y, y, None, 1.0)
    with pytest.raises(ValueError):
        fused_attention(x, x, x, torch.zeros(2, 431, 430, device=card), 1.0)
