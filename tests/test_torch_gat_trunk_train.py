"""K5 (the training GAT block) on the CPU: its plain version against the
JAX package's explicit-mask oracle at the default rates, the wrapper at
rate 0 against the JAX training trunk, and the dropout-mask hash.

The masks come from the port's hash (`nn.dropout_masks`) and are handed to
both sides as numpy arrays; the JAX kernels run in interpret mode, as
tests/test_pallas_gat_train.py runs them. Bars: values atol 1e-5, every
VJP cotangent scaled by its max within 1e-4, in f32; the qkv key-bias slice
has a zero true gradient and is held to an absolute bar instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu.nn import pallas_gat_train as pgt
from gator_tpu_torch.nn import dropout_masks as dm
from gator_tpu_torch.nn.gat_trunk_train import (BLOCK_PARAM_KEYS, BlockCfg,
                                                block_masks,
                                                gat_block_train_ref,
                                                gat_trunk_train)

C, H, J, B = 64, 4, 17, 4
RATES = dict(attn_rate=0.4, proj_rate=0.4, mlp_rate=0.1, path_rate=0.2)


def _block_params(seed):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(0, 0.08, shape).astype(np.float32)

    p = {
        "norm1_scale": 1.0 + w(C), "norm1_bias": w(C),
        "qkv_w": w(C, 3 * C), "qkv_b": w(3 * C),
        "proj_w": w(C, C), "proj_b": w(C),
        "gcn_w0": w(C, C), "gcn_w1": w(C, C), "gcn_m": w(J, C),
        "gcn_adj_diag": 1.0 + w(J, 1),
        "gcn_adj_off": w(J, J) * (1 - np.eye(J, dtype=np.float32)),
        "gcn_b": w(C),
        "x0_w": w(C, C), "x0_b": w(C), "x1_w": w(C, C // 8),
        "x1_b": w(C // 8), "back_w0": w(C, C), "back_w1": w(C // 8, C),
        "back_b": w(C), "norm2_scale": 1.0 + w(C), "norm2_bias": w(C),
        "fc1_w": w(C, 4 * C), "fc1_b": w(4 * C),
        "fc2_w": w(4 * C, C), "fc2_b": w(C),
    }
    return {k: p[k] for k in BLOCK_PARAM_KEYS}


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, J, C)).astype(np.float32)
    bias = rng.normal(0, 0.3, (H, J, J)).astype(np.float32)
    xm = (rng.uniform(size=(2, J, J)) < 0.4).astype(np.float32)
    cot = rng.normal(0, 1, (B, J, C)).astype(np.float32)
    return x, bias, xm, cot


def _torch_vjp(fn, args, cot):
    """(output, cotangents of every arg) through torch autograd."""
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _assert_cotangents(names, got, want, c):
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        if name == "qkv_b":
            # softmax is invariant to a shift of the keys: the key-bias
            # slice has a zero true gradient, rounding noise on both sides
            assert np.abs(a[c:2 * c]).max() < 1e-5, name
            keep = np.ones(a.shape, bool)
            keep[c:2 * c] = False
            a, b = a[keep], b[keep]
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4,
                                   err_msg=f"cotangent {name}")


def test_plain_block_matches_jax_oracle_at_default_rates():
    p = _block_params(0)
    x, bias, xm, cot = _inputs()
    cfg = BlockCfg(num_heads=H, block=1, seed=77, **RATES)
    masks = block_masks(cfg, B, J, C)
    assert all(m is not None for m in masks.values())
    np_masks = {k: m.numpy() for k, m in masks.items()}

    def port(x, bias, *plist):
        return gat_block_train_ref(x, bias, dict(zip(BLOCK_PARAM_KEYS, plist)),
                                   xm, masks, H)

    args = [x, bias] + [p[k] for k in BLOCK_PARAM_KEYS]
    out, got = _torch_vjp(port, args, cot)

    def oracle(x, bias, *plist):
        return pgt.gat_block_train_ref(
            x, bias, dict(zip(BLOCK_PARAM_KEYS, plist)), xm,
            {k: jnp.asarray(m) for k, m in np_masks.items()}, H)

    want_out, vjp = jax.vjp(oracle, *[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(out, np.asarray(want_out), atol=1e-5)
    _assert_cotangents(("dx", "dbias") + BLOCK_PARAM_KEYS, got,
                       vjp(jnp.asarray(cot)), C)


def test_trunk_wrapper_at_rate0_matches_jax_trunk():
    bps = [_block_params(s) for s in (2, 3)]
    x, bias, xm, cot = _inputs(4)
    zero = dict(attn_rate=0.0, proj_rate=0.0, mlp_rate=0.0,
                drop_path_rate=0.0)
    n = len(BLOCK_PARAM_KEYS)

    def unflat(plist):
        return [dict(zip(BLOCK_PARAM_KEYS, plist[i * n:(i + 1) * n]))
                for i in range(2)]

    flat = [bp[k] for bp in bps for k in BLOCK_PARAM_KEYS]

    def port(x, bias, *plist):
        return gat_trunk_train(x, bias, unflat(plist), xm, H, 5, **zero)

    out, got = _torch_vjp(port, [x, bias] + flat, cot)

    def jax_trunk(x, bias, *plist):
        return pgt.gat_trunk_train(x, bias, unflat(plist), xm, H,
                                   jnp.asarray([5], jnp.int32),
                                   interpret=True, **zero)

    want_out, vjp = jax.vjp(jax_trunk, *[jnp.asarray(a)
                                         for a in [x, bias] + flat])
    np.testing.assert_allclose(out, np.asarray(want_out), atol=1e-5)
    _assert_cotangents(("dx", "dbias") + BLOCK_PARAM_KEYS * 2, got,
                       vjp(jnp.asarray(cot)), C)


def test_block_masks_follow_the_rates():
    cfg = BlockCfg(num_heads=H, block=0, seed=3, attn_rate=0.0,
                   proj_rate=0.4, mlp_rate=0.1, path_rate=0.0)
    masks = block_masks(cfg, B, J, C)
    assert masks["attn"] is None and masks["dp1"] is None
    assert masks["proj"].shape == (B, J, C)
    assert masks["mlp1"].shape == (B, J, 4 * C)
    assert set(np.unique(masks["proj"].numpy())) <= {0.0,
                                                     np.float32(1 / 0.6)}
    # the per-block unit and the per-sample key: blocks and samples differ
    other = block_masks(BlockCfg(num_heads=H, block=1, seed=3, **RATES),
                        B, J, C)
    assert not torch.equal(other["mlp1"], masks["mlp1"])
    assert not torch.equal(masks["mlp1"][0], masks["mlp1"][1])


@pytest.mark.parametrize("rate", [0.1, 0.4, 0.9])
def test_mask_hash_keep_fraction(rate):
    m = dm.keep_mask(11, 2, dm.M_MLP1, rate, 4, (250000,))
    kept = (m > 0).float().mean().item()
    assert abs(kept - (1 - rate)) < 0.01
    assert torch.all((m == 0) | (m == np.float32(1 / (1 - rate))))


def test_mask_hash_is_keyed_by_every_component():
    base = dict(seed=5, unit=3, mid=dm.M_PROJ, rate=0.5, batch=3,
                shape=(64,))
    ref = dm.keep_mask(**base)
    assert torch.equal(ref, dm.keep_mask(**base))
    for key, val in (("seed", 6), ("unit", 4), ("mid", dm.M_MLP2)):
        assert not torch.equal(ref, dm.keep_mask(**dict(base, **{key: val})))
    assert not torch.equal(ref[0], ref[1])          # the sample index
    assert not torch.equal(ref[0, :32], ref[0, 32:])  # the element index
    assert dm.keep_mask(**dict(base, rate=0.0)) is None


def test_mask_hash_matches_uint32_reference():
    """The int64 emulation equals plain uint32 arithmetic (the CUDA side's
    math), checked on numpy uint32 with wrap-around."""
    def fmix(h):
        h = np.uint32(h)
        h ^= h >> np.uint32(16)
        h = np.uint32((int(h) * 0x85EBCA6B) & 0xFFFFFFFF)
        h ^= h >> np.uint32(13)
        h = np.uint32((int(h) * 0xC2B2AE35) & 0xFFFFFFFF)
        return h ^ (h >> np.uint32(16))

    seed, unit, mid = 123456789, 258, dm.M_SELF0 + 1
    k = fmix(seed ^ 0x9E3779B9)
    k = fmix(k ^ np.uint32((unit * 0x85EBCA77 + 0x165667B1) & 0xFFFFFFFF))
    bits = dm.mask_bits(seed, unit, mid, 3, 40)
    for sample in range(3):
        ks = fmix(k ^ np.uint32(sample * 32 + mid))
        for i in range(40):
            want = fmix(ks ^ np.uint32((i * 0x9E3779B9) & 0xFFFFFFFF))
            assert int(bits[sample, i]) == int(want)
