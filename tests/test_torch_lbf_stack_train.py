"""K4 (the training LBF layer) on the CPU: its plain version against the
JAX package's explicit-mask oracle at the default rates, and the wrapper at
rate 0 against the JAX training stack (interpret mode, as
tests/test_pallas_mdr_train.py runs it).

The masks come from the port's hash and are handed to both sides as numpy
arrays. Bars: values atol 1e-5, every VJP cotangent scaled by its max
within 1e-4, in f32; the self-attention key bias (l1_b) has a zero true
gradient and is held to an absolute bar instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

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
