"""K3 on the CPU: the port's plain `fused_attention_ref` and the autograd
Function's plain backward against the JAX package's `fused_attention`
(which runs its plain `_xla_attention` off the TPU), on the same numpy
inputs. Bars: f32 outputs within 1e-5; gradients scaled by their max within
1e-5. The kernel itself is held against `fused_attention_ref` on the card
(tests/test_torch_eval_kernels_cuda.py, tests/test_torch_motionbert_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu.nn.pallas_attention import fused_attention as jax_fused
from gator_tpu_torch.nn import attend
from gator_tpu_torch.nn.fused_attention import (SHORT_TOKENS, fused_attention,
                                                fused_attention_ref, route)

# (B, Nq, Nk, H, D, bias): the MDR self-attention (431 x 431, 2 heads of
# 32) with and without a bias, the GAT attention shape (17 x 17, 8 heads of
# 16, biased), and a Nq != Nk shape
SHAPES = [(2, 431, 431, 2, 32, False), (2, 431, 431, 2, 32, True),
          (3, 17, 17, 8, 16, True), (2, 200, 90, 2, 32, True)]


def _inputs(b, nq, nk, h, d, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, nk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, nk, h, d)).astype(np.float32)
    bias = (rng.normal(size=(h, nq, nk)).astype(np.float32)
            if with_bias else None)
    return q, k, v, bias


def _t(a, grad=False):
    return None if a is None else torch.tensor(a, requires_grad=grad)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ref_matches_jax(shape):
    *dims, with_bias = shape
    d = dims[-1]
    q, k, v, bias = _inputs(*dims, with_bias)
    scale = d ** -0.5
    want = np.asarray(jax_fused(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v),
                                None if bias is None else jnp.asarray(bias),
                                scale))
    got = fused_attention_ref(_t(q), _t(k), _t(v), _t(bias), scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # on a CPU tensor the public function is the plain version, unlaunched
    before = fused_attention.launches
    np.testing.assert_array_equal(
        fused_attention(_t(q), _t(k), _t(v), _t(bias), scale).numpy(),
        got.numpy())
    assert fused_attention.launches == before


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[2]],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_jax_grad(shape):
    *dims, with_bias = shape
    d = dims[-1]
    q, k, v, bias = _inputs(*dims, with_bias, seed=1)
    cot = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    scale = d ** -0.5

    def loss(qq, kk, vv, bb):
        return (jax_fused(qq, kk, vv, bb, scale) * cot).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    tq, tk, tv, tb = _t(q, True), _t(k, True), _t(v, True), _t(bias, True)
    out = fused_attention(tq, tk, tv, tb, scale)
    out.backward(torch.from_numpy(cot))
    for name, got, ref in zip(("dq", "dk", "dv", "dbias"),
                              (tq.grad, tk.grad, tv.grad, tb.grad), want):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, (name, err)


def test_attend_routes_by_score_tile_size():
    """Score tiles of at least 128² go through K3 (here its plain version),
    smaller ones and use_kernel=False stay on the plain einsum path; in f32
    all of them compute the same function."""
    q, k, v, _ = _inputs(2, 431, 431, 2, 32, False, seed=3)
    tq, tk, tv = _t(q), _t(k), _t(v)
    ref = fused_attention_ref(tq, tk, tv, None, 0.2)
    np.testing.assert_array_equal(attend(tq, tk, tv, None, 0.2).numpy(),
                                  ref.numpy())
    plain = attend(tq, tk, tv, None, 0.2, use_kernel=False)
    np.testing.assert_allclose(plain.numpy(), ref.numpy(), atol=1e-5)
    small = attend(tq[:, :17], tk[:, :17], tv[:, :17], None, 0.2)
    np.testing.assert_allclose(
        small.numpy(),
        fused_attention_ref(tq[:, :17], tk[:, :17], tv[:, :17], None,
                            0.2).numpy(), atol=1e-5)


@pytest.mark.parametrize("nq, nk, with_bias, want", [
    (17, 17, False, "short"), (16, 16, False, "short"),
    (1, 1, False, "short"), (32, 32, False, "short"),
    (17, 17, True, "short"), (33, 33, False, "tiled"),
    (17, 431, False, "tiled"), (431, 431, False, "tiled"),
    (200, 90, True, "tiled")])
def test_route_by_query_and_key_counts(nq, nk, with_bias, want):
    """The kernel a CUDA launch takes depends on Nq and Nk alone: up to
    SHORT_TOKENS of each (MotionBERT's 16-17 tokens) the short-row kernel,
    else the tiled one (the 431-key eval attention); a bias changes
    nothing."""
    q, k, _, bias = _inputs(1, nq, nk, 2, 8, with_bias)
    assert (bias is not None) == with_bias
    assert SHORT_TOKENS == 32
    assert route(q.shape[1], k.shape[1]) == want
