"""K4 (the training LBF layer) on the CPU: its plain version against the
JAX package's explicit-mask oracle at the default rates, and the wrapper at
rate 0 against the JAX training stack (interpret mode, as
tests/test_pallas_mdr_train.py runs it).

The masks come from the port's hash and are handed to both sides as numpy
arrays. Bars: values atol 1e-5, every VJP cotangent scaled by its max
within 1e-4, in f32; the self-attention key bias (l1_b) has a zero true
gradient and is held to an absolute bar instead. In bf16 the plain version
is held to the JAX training stack compiled with every bf16 cast kept
(test_torch_lbf_layer.exact), by the bit-equal share and the mean and max
differences stated in the test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lbf_layer import exact, random_layer_params

from gator_tpu.nn import pallas_mdr_train as pmt
from gator_tpu_torch.nn.lbf_stack_train import (DEFAULT_RATES,
                                                LAYER_PARAM_KEYS, ZERO_RATES,
                                                LayerCfg, layer_masks,
                                                lbf_layer_train_ref,
                                                lbf_stack_train)

C, H, NV, NJ, B = 64, 2, 37, 5, 4


def _params(seed):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(0, 0.08, shape).astype(np.float32)

    p = {
        "norm1_scale": 1.0 + w(C), "norm1_bias": w(C),
        "wq": w(C, C), "wk": w(C, C), "wv": w(C, C),
        "proj_w": w(C, C), "proj_b": w(C),
        "norm2_scale": 1.0 + w(C), "norm2_bias": w(C),
        "fc1_w": w(C, 4 * C), "fc1_b": w(4 * C),
        "fc2_w": w(4 * C, C), "fc2_b": w(C),
        "a2": 1.0 + w(C), "b2": w(C),
    }
    for i in range(4):
        p[f"l{i}_w"] = w(C, C)
        p[f"l{i}_b"] = w(C)
    return p


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, NV, C)).astype(np.float32),
            rng.normal(0, 1, (B, NJ, C)).astype(np.float32),
            rng.normal(0, 1, (B, NV, C)).astype(np.float32))


def _torch_vjp(fn, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _assert_cotangents(names, got, want):
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        if name == "l1_b":
            # a uniform key shift leaves the softmax unchanged: zero true
            # gradient, rounding noise on both sides
            assert np.abs(a).max() < 1e-5 and np.abs(b).max() < 1e-5
            continue
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4,
                                   err_msg=f"cotangent {name}")


def test_plain_layer_matches_jax_oracle_at_default_rates():
    p = _params(0)
    x, jt, cot = _inputs()
    cfg = LayerCfg(num_heads=H, layer=2, seed=41, rates=DEFAULT_RATES)
    masks = layer_masks(cfg, B, NV, NJ, C)
    assert all(m is not None for m in masks.values())
    np_masks = {k: jnp.asarray(m.numpy()) for k, m in masks.items()}
    args = [x, jt] + [p[k] for k in LAYER_PARAM_KEYS]

    def port(x, jt, *plist):
        return lbf_layer_train_ref(x, jt, dict(zip(LAYER_PARAM_KEYS, plist)),
                                   masks, H)

    out, got = _torch_vjp(port, args, cot)

    def oracle(x, jt, *plist):
        return pmt.lbf_layer_train_ref(
            x, jt, dict(zip(LAYER_PARAM_KEYS, plist)), np_masks, H)

    want_out, vjp = jax.vjp(oracle, *[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(out, np.asarray(want_out), atol=1e-5)
    _assert_cotangents(("dx", "djt") + LAYER_PARAM_KEYS, got,
                       vjp(jnp.asarray(cot)))


def test_stack_wrapper_at_rate0_matches_jax_stack():
    ps = [_params(s) for s in (3, 4, 5)]
    x, jt, cot = _inputs(6)
    n = len(LAYER_PARAM_KEYS)
    flat = [p[k] for p in ps for k in LAYER_PARAM_KEYS]

    def unflat(plist):
        return [dict(zip(LAYER_PARAM_KEYS, plist[i * n:(i + 1) * n]))
                for i in range(3)]

    def port(x, jt, *plist):
        return lbf_stack_train(x, jt, unflat(plist), H, 9, rates=ZERO_RATES)

    out, got = _torch_vjp(port, [x, jt] + flat, cot)

    def jax_stack(x, jt, *plist):
        return pmt.lbf_stack_train(x, jt, unflat(plist), H,
                                   jnp.asarray([9], jnp.int32),
                                   rates=pmt.ZERO_RATES, interpret=True)

    want_out, vjp = jax.vjp(jax_stack, *[jnp.asarray(a)
                                         for a in [x, jt] + flat])
    np.testing.assert_allclose(out, np.asarray(want_out), atol=1e-5)
    _assert_cotangents(("dx", "djt") + LAYER_PARAM_KEYS * 3, got,
                       vjp(jnp.asarray(cot)))


def test_layer_masks_shapes_and_zero_rates():
    cfg = LayerCfg(num_heads=H, layer=0, seed=1, rates=DEFAULT_RATES)
    masks = layer_masks(cfg, 2, NV, NJ, C)
    shapes = {"attn": (2, H, NV, NJ), "proj": (2, NV, C), "dp1": (2, 1, 1),
              "mlp1": (2, NV, 4 * C), "mlp2": (2, NV, C), "dp2": (2, 1, 1),
              "self": (2, H, NV, NV), "out": (2, NV, C)}
    assert {k: tuple(m.shape) for k, m in masks.items()} == shapes
    zero = layer_masks(LayerCfg(num_heads=H, layer=0, seed=1,
                                rates=ZERO_RATES), 2, NV, NJ, C)
    assert all(m is None for m in zero.values())
    # the LBF layer's units differ from one another and from K5's blocks
    other = layer_masks(LayerCfg(num_heads=H, layer=1, seed=1,
                                 rates=DEFAULT_RATES), 2, NV, NJ, C)
    assert not torch.equal(other["self"], masks["self"])


@pytest.mark.parametrize("depth,min_equal,mean_bar", [(1, 0.95, 2e-4),
                                                      (3, 0.6, 2.5e-3)])
def test_plain_stack_bf16_matches_jax_kernel(depth, min_equal, mean_bar):
    """bf16, rate 0: the plain version against the JAX training stack in
    interpret mode, every cast to bf16 kept. The JAX kernel rounds the
    dropped self-attention probabilities to bf16 before the PV product
    (pallas_mdr_train.py:257), and so does the plain version. The weights
    are bf16 values held in f32, as the kernels pack them, so that the JAX
    kernel's f32 biases and norm scales equal them. Measured at seeds 8
    and 9: one layer 98.1-98.7 % bit-equal, mean abs 3.6e-5-4.0e-5 (with
    the probabilities left in f32, 74.2-74.5 % and 6.6e-4-6.9e-4); three
    layers 68.4-69.7 %, 1.45e-3-1.73e-3 (39.1-42.3 %, 3.2e-3-3.7e-3).
    Bars: the shares and means above, max abs 2^-5 (two bf16 ulps at the
    outputs' scale)."""
    rng = np.random.default_rng(8)
    ps = [{k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
           for k, v in random_layer_params(rng).items()}
          for _ in range(depth)]
    x = rng.normal(size=(B, NV, C)).astype(np.float32)
    jt = rng.normal(size=(B, NJ, C)).astype(np.float32)
    n = len(LAYER_PARAM_KEYS)

    def jax_stack(x, jt, *plist):
        lps = [dict(zip(LAYER_PARAM_KEYS, plist[i * n:(i + 1) * n]))
               for i in range(depth)]
        return pmt.lbf_stack_train(x, jt, lps, H, jnp.asarray([9], jnp.int32),
                                   rates=pmt.ZERO_RATES, interpret=True)

    want = exact(jax_stack, jnp.asarray(x, jnp.bfloat16),
                 jnp.asarray(jt, jnp.bfloat16),
                 *[jnp.asarray(p[k]) for p in ps for k in LAYER_PARAM_KEYS])
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    got = lbf_stack_train(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(jt).to(torch.bfloat16),
                          [{k: torch.from_numpy(v) for k, v in p.items()}
                           for p in ps], H, 9, rates=ZERO_RATES)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = (got.float() - want).abs()
    stats = ((got.float() == want).float().mean().item(),
             diff.mean().item(), diff.max().item())
    assert stats[0] >= min_equal and stats[1] <= mean_bar \
        and stats[2] <= 2.0 ** -5, stats
