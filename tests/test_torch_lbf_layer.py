"""K2-layer, one LBF layer with unfolded weights: the port's `lbf_layer`
(its plain version `lbf_layer_ref` on the CPU) against the JAX package's
`lbf_layer_fused` (interpret mode) and `lbf_layer_xla`; the per-layer
weight packing (`extract_layer_params`, `layer_weights_from_jax`,
`fold_stack_weights` built on them); and the "lbf layers" stage of
`gator_tpu_torch.tools.profile_serving` against three JAX `lbf_layer`
calls. The CUDA kernels are held against `lbf_layer_ref` in
test_torch_layer_kernels_cuda.py.

Bars (the same inputs and weights, made with numpy, on both sides): f32
max abs 1e-5; bf16 at least 95 % of the elements bit-equal to the JAX
output, mean abs 5e-4 and max abs 2^-5 (K2's stack rounding, which keeps
f32 where this layer rounds, reaches 40.9 % and 2.7e-3 on such inputs).

The JAX side runs compiled with `xla_allow_excess_precision` off
(`exact`): by default XLA's CPU compiler drops a cast to bf16 that is
followed by a cast back to f32, so a jitted or interpret-mode run keeps
f32 where the kernel rounds (test_jax_keeps_bf16_casts_only_when_told).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu.nn import pallas_mdr
from test_torch_convert import jax_variables
from gator_tpu_torch import assets as port_assets
from gator_tpu_torch.convert import layer_weights_from_jax, state_dict_from_jax
from gator_tpu_torch.models import GATOR, GatorSpec
from gator_tpu_torch.nn import (extract_layer_params, fold_stack_weights,
                                lbf_layer, lbf_layer_ref)
from gator_tpu_torch.tools import profile_lbf, profile_serving

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def random_layer_params(rng, c=64, hidden=256):
    """One LBF layer in the JAX package's form (`LAYER_PARAM_KEYS`,
    matrices [in, out]) with init-like scales, as numpy f32."""
    def mat(n_in, n_out):
        return rng.normal(0.0, n_in ** -0.5, size=(n_in, n_out))

    def vec(n, mean=0.0):
        return mean + rng.normal(0.0, 0.1, size=(n,))

    p = {"norm1_scale": vec(c, 1.0), "norm1_bias": vec(c),
         "wq": mat(c, c), "wk": mat(c, c), "wv": mat(c, c),
         "proj_w": mat(c, c), "proj_b": vec(c),
         "norm2_scale": vec(c, 1.0), "norm2_bias": vec(c),
         "fc1_w": mat(c, hidden), "fc1_b": vec(hidden),
         "fc2_w": mat(hidden, c), "fc2_b": vec(c),
         "a2": vec(c, 1.0), "b2": vec(c)}
    for i in range(4):
        p[f"l{i}_w"], p[f"l{i}_b"] = mat(c, c), vec(c)
    assert tuple(p) == pallas_mdr.LAYER_PARAM_KEYS
    return {k: v.astype(np.float32) for k, v in p.items()}


def exact(fn, *args):
    """fn(*args) jitted with every cast to bf16 kept (no excess
    precision), as the kernel rounds on the TPU; the backend's
    optimisation is off, which shortens the compile."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False,
                          "xla_backend_optimization_level": 0})(*args)


def assert_close(got: torch.Tensor, want, dtype: str, what: str,
                 min_equal: float = 0.95, mean_bar: float = 5e-4):
    """The bars of this file: f32 max abs 1e-5; bf16 the bit-equal
    fraction, mean abs and max abs. -> (fraction equal, mean, max)."""
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    diff = (got.float() - want).abs()
    frac = (got.float() == want).float().mean().item()
    stats = (frac, diff.mean().item(), diff.max().item())
    if dtype == "float32":
        assert stats[2] <= 1e-5, (what, stats)
    else:
        assert frac >= min_equal and stats[1] <= mean_bar \
            and stats[2] <= 2.0 ** -5, (what, stats)
    return stats


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nj", [17, 19])
def test_lbf_layer_matches_jax(nj, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(nj)
    params = random_layer_params(rng)
    verts = rng.normal(size=(4, 431, 64)).astype(np.float32)
    joints = rng.normal(size=(4, nj, 64)).astype(np.float32)
    jparams = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jv, jj = jnp.asarray(verts, jdt), jnp.asarray(joints, jdt)
    fused = exact(lambda v, j, p: pallas_mdr.lbf_layer_fused(
        v, j, p, 2, interpret=True), jv, jj, jparams)
    xla = exact(lambda v, j, p: pallas_mdr.lbf_layer_xla(v, j, p, 2), jv, jj,
                jparams)
    weights = layer_weights_from_jax(params, tdt, "cpu")
    tv, tj = torch.from_numpy(verts).to(tdt), torch.from_numpy(joints).to(tdt)
    got = lbf_layer(tv, tj, weights, 2)
    assert got.dtype == tdt and got.shape == (4, 431, 64)
    assert torch.equal(got, lbf_layer_ref(tv, tj, weights, 2))
    assert_close(got, fused, dtype, "fused")
    assert_close(got, xla, dtype, "xla")


def test_jax_keeps_bf16_casts_only_when_told():
    """Why this file compiles the JAX side with `exact`: by default the
    interpret-mode kernel, jitted, is far from the same math run op by op
    in bf16 (45 % bit-equal on these inputs), and with every cast kept it
    is within the f32 sum-order noise of it (99.5 %)."""
    rng = np.random.default_rng(17)
    params = {k: jnp.asarray(v, jnp.bfloat16)
              for k, v in random_layer_params(rng).items()}
    v = jnp.asarray(rng.normal(size=(4, 431, 64)), jnp.bfloat16)
    j = jnp.asarray(rng.normal(size=(4, 17, 64)), jnp.bfloat16)

    def fused(v, j, p):
        return pallas_mdr.lbf_layer_fused(v, j, p, 2, interpret=True)

    with jax.disable_jit():
        eager = np.array(pallas_mdr.lbf_layer_xla(v, j, params, 2).astype(
            jnp.float32))

    def frac(out):
        return (np.array(out.astype(jnp.float32)) == eager).mean()

    assert frac(jax.jit(fused)(v, j, params)) < 0.6
    assert frac(exact(fused, v, j, params)) > 0.99


@pytest.fixture(scope="module")
def converted(small_assets):
    """The JAX init of a depth-1 GATOR on the 890-vertex assets, and the
    port's model with the same weights."""
    jspec = JaxGatorSpec.from_assets(small_assets, embed_dim=128, depth=1,
                                     alpha=False)
    variables = jax_variables(init_gator, jspec, 6)
    passets = port_assets.build_assets("human36", data_dirs=[],
                                       synthetic_vertex_num=890, seed=0)
    model = GATOR(GatorSpec.from_assets(passets, embed_dim=128, depth=1,
                                        alpha=False))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return variables["params"]["pose2mesh"], model


def test_layer_packing_matches_jax(converted):
    """extract_layer_params equals the JAX extraction packed by
    layer_weights_from_jax, exactly, and fold_stack_weights is those three
    layers stacked (the same flat tensor, offsets and views)."""
    mdr_params, model = converted
    for dt in (torch.float32, torch.bfloat16):
        packs = []
        for i in range(3):
            got = extract_layer_params(model.pose2mesh, i, dt, "cpu")
            want = layer_weights_from_jax(
                pallas_mdr.extract_layer_params(mdr_params, i), dt, "cpu")
            assert got.flat.shape[0] == 1 and got.dtype == dt
            assert torch.equal(got.flat, want.flat)
            assert torch.equal(got.offsets, want.offsets)
            packs.append(got)
        stack = fold_stack_weights(model.pose2mesh, dt, "cpu")
        assert torch.equal(stack.flat, torch.cat([p.flat for p in packs]))
        assert torch.equal(stack.offsets, packs[0].offsets)
        for li, pack in enumerate(packs):
            assert list(stack.layers[li]) == list(pack.layers[0])
            for name, view in pack.layers[0].items():
                assert torch.equal(stack.layers[li][name], view), name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_profile_serving_lbf_layers_stage_matches_jax(converted, dtype):
    """The stage's three layers against three JAX `lbf_layer` calls. In
    bf16 each layer is held on the JAX input of that layer: one bf16 ulp
    that differs in a layer's output reaches every row of its sample
    through the next self-attention, so the chained outputs drift apart
    (below the 95 % bar after three layers, with each layer above it)."""
    tdt, jdt = DTYPES[dtype]
    mdr_params, model = converted
    stages = profile_serving.make_stages(model, tdt, batch=3)
    fn, (verts, joints, layers) = stages["lbf layers"]
    assert len(layers) == 3
    lps = [pallas_mdr.extract_layer_params(mdr_params, i, dtype=jdt)
           for i in range(3)]

    def jax_layers(v, j, lps):
        for lp in lps:
            v = pallas_mdr.lbf_layer(v, j, lp, 2)
        return v

    v = jnp.asarray(verts.float().numpy(), jdt)
    j = jnp.asarray(joints.float().numpy(), jdt)
    if dtype == "float32":
        got = fn(verts, joints, layers)
        assert got.shape == verts.shape == (3, model.spec.mdr.coarse_num, 64)
        assert_close(got, exact(jax_layers, v, j, lps), dtype, "3 layers")
        return
    for i in range(3):
        got = fn(torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt),
                 joints, layers[i:i + 1])
        v = exact(jax_layers, v, j, lps[i:i + 1])
        assert_close(got, v, dtype, f"layer {i}")


def test_profile_serving_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_serving.main([])


def test_profile_lbf_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_lbf.main([])
