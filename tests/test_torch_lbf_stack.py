"""K2, the MDR LBF stack: the port's plain version `lbf_stack_ref` against
the JAX package's fused kernel (interpret mode) and its XLA form, at 56
and at the full 431 vertex tokens, for 17 and 19 joints. The CUDA kernels
are held against `lbf_stack_ref` in test_torch_kernels_cuda.py.

Same weights on both sides (flax init -> `state_dict_from_jax` -> the
port's `GATOR`). Bars: f32 atol 2e-4 (tests/test_serving.py:136); bf16
against the interpret-mode kernel compiled with every bf16 cast kept, the
bit-equal share and the mean and max differences stated in the test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu.nn.pallas_mdr import (extract_layer_params, lbf_stack_fused,
                                     lbf_stack_xla)
from test_torch_convert import jax_variables
from test_torch_lbf_layer import exact
from gator_tpu_torch import assets as port_assets
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.models import GATOR, GatorSpec
from gator_tpu_torch.nn import fold_stack_weights, lbf_stack, lbf_stack_ref


def _setup(joint_set, jax_assets, seed):
    alpha = joint_set == "coco"
    jspec = JaxGatorSpec.from_assets(jax_assets, embed_dim=128, depth=1,
                                     alpha=alpha)
    variables = jax_variables(init_gator, jspec, seed)
    passets = port_assets.build_assets(joint_set, data_dirs=[],
                                       synthetic_vertex_num=890, seed=0)
    model = GATOR(GatorSpec.from_assets(passets, embed_dim=128, depth=1,
                                        alpha=alpha))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jspec, variables["params"]["pose2mesh"], model.pose2mesh


@pytest.fixture(scope="module", params=["human36", "coco"])
def stack_case(request, small_assets, small_assets_coco):
    jax_assets = {"human36": small_assets, "coco": small_assets_coco}
    return _setup(request.param, jax_assets[request.param], seed=4)


@pytest.mark.parametrize("nv", [56, 431])
def test_lbf_stack_ref_matches_jax(stack_case, nv):
    jspec, mdr_params, mdr = stack_case
    j = jspec.gat.num_joint
    rng = np.random.default_rng(nv)
    verts = rng.normal(size=(2, nv, 64)).astype(np.float32)
    joints = rng.normal(size=(2, j, 64)).astype(np.float32)
    lps = [extract_layer_params(mdr_params, i) for i in range(3)]
    fused = lbf_stack_fused(jnp.asarray(verts), jnp.asarray(joints), lps,
                            jspec.mdr.num_heads, group=2, interpret=True)
    xla = lbf_stack_xla(jnp.asarray(verts), jnp.asarray(joints), lps,
                        jspec.mdr.num_heads)
    weights = fold_stack_weights(mdr, torch.float32, "cpu")
    got = lbf_stack_ref(torch.from_numpy(verts), torch.from_numpy(joints),
                        weights, jspec.mdr.num_heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=2e-4)
    disp = lbf_stack(torch.from_numpy(verts), torch.from_numpy(joints),
                     weights, jspec.mdr.num_heads)
    assert torch.equal(disp, got)



@pytest.mark.parametrize("nv", [56, 431])
def test_lbf_stack_ref_bf16_matches_jax_kernel(stack_case, nv):
    """bf16: `lbf_stack_ref` against `lbf_stack_fused` (interpret mode,
    every cast to bf16 kept: test_torch_lbf_layer.exact). Both round the
    normalised self-attention probabilities to bf16, but the JAX kernel
    folds wv into proj and l2 into l3 per head in f32 and rounds the folded
    weights (pallas_mdr.py:330), where the port rounds each weight, so only
    about half of the outputs are bit-equal. Bars, from measuring both
    roundings of the probabilities at 3 layers (about 50 % equal, mean abs
    1.9e-3, max abs 1.56e-2 at J=17; these cases measure 48.0-49.9 %,
    1.91e-3-1.99e-3 and 1.56e-2 at J=17 and 19): at least 45 % bit-equal,
    mean abs 2.5e-3, max abs 3.2e-2 (two bf16 ulps at the outputs'
    scale)."""
    jspec, mdr_params, mdr = stack_case
    j = jspec.gat.num_joint
    rng = np.random.default_rng(nv + 1)
    verts = rng.normal(size=(2, nv, 64)).astype(np.float32)
    joints = rng.normal(size=(2, j, 64)).astype(np.float32)
    lps = [extract_layer_params(mdr_params, i) for i in range(3)]
    fused = exact(lambda v, jt, p: lbf_stack_fused(
        v, jt, p, jspec.mdr.num_heads, group=2, interpret=True),
        jnp.asarray(verts, jnp.bfloat16), jnp.asarray(joints, jnp.bfloat16),
        lps)
    weights = fold_stack_weights(mdr, torch.bfloat16, "cpu")
    got = lbf_stack_ref(torch.from_numpy(verts).to(torch.bfloat16),
                        torch.from_numpy(joints).to(torch.bfloat16), weights,
                        jspec.mdr.num_heads)
    assert got.dtype == torch.bfloat16 and got.shape == verts.shape
    want = torch.from_numpy(np.asarray(fused.astype(jnp.float32)))
    diff = (got.float() - want).abs()
    stats = ((got.float() == want).float().mean().item(),
             diff.mean().item(), diff.max().item())
    assert stats[0] >= 0.45 and stats[1] <= 2.5e-3 and stats[2] <= 3.2e-2, \
        stats
